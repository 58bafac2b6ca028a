// Native batch packer: molecules -> padded dense arrays.
//
// The port's own copy of the JAX package's packer (conan_fgw_tpu/native/
// packer.cpp): the same C interface and the same output bytes. Packing in
// Python costs as much as a graphed training step on the card, so this
// fills every output buffer in one pass over concatenated per-molecule
// arrays. Bound via ctypes (conan_fgw_tpu_torch/data/native.py), which
// releases the interpreter lock for the call, so a prefetch thread packs
// while the main thread steps.
//
// Memory layout contract (all row-major, caller-allocated):
//   inputs, concatenated over records r = 0..B_real-1:
//     z_concat      [sum_n]            int32
//     pos_concat    [sum_n * K * 3]    float   (per record: (K, n, 3))
//     x2d_concat    [sum_n * NF]       int32
//     bonds_concat  [sum_e * 2]        int32
//     battr_concat  [sum_e * NBF]      float
//     n_atoms, n_bonds [B_real]        int32
//     y             [B_real]           float
//   outputs (any prior content: every byte is written, the padding zeroed,
//   so a reused buffer needs no memset):
//     z_out      [B*K*N]        pos_out   [B*K*N*3]
//     atom_mask  [B*N] uint8    x2d_out   [B*N*NF]
//     bond_adj   [B*N*N] uint8  bond_attr [B*N*N*NBF]
//     y_out      [B]            mol_mask  [B] uint8
//
// Padding atoms are parked far away (1e4 + 10*i) so no radius edge forms;
// padding molecules (b >= B_real) are all zeros.

#include <cstdint>
#include <cstring>

extern "C" {

void pack_batch(
    int32_t B_real, int32_t B, int32_t K, int32_t N, int32_t NF, int32_t NBF,
    const int32_t* z_concat, const float* pos_concat, const int32_t* x2d_concat,
    const int32_t* bonds_concat, const float* battr_concat,
    const int32_t* n_atoms, const int32_t* n_bonds, const float* y,
    int32_t* z_out, float* pos_out, uint8_t* atom_mask, int32_t* x2d_out,
    uint8_t* bond_adj, float* bond_attr, float* y_out, uint8_t* mol_mask) {
  const int64_t nb = B, nk = K, nn = N;
  std::memset(z_out, 0, sizeof(int32_t) * nb * nk * nn);
  std::memset(pos_out, 0, sizeof(float) * nb * nk * nn * 3);
  std::memset(atom_mask, 0, nb * nn);
  std::memset(x2d_out, 0, sizeof(int32_t) * nb * nn * NF);
  std::memset(bond_adj, 0, nb * nn * nn);
  std::memset(bond_attr, 0, sizeof(float) * nb * nn * nn * NBF);
  std::memset(y_out, 0, sizeof(float) * nb);
  std::memset(mol_mask, 0, nb);
  int64_t atom_off = 0;
  int64_t bond_off = 0;
  for (int32_t b = 0; b < B_real; ++b) {
    const int32_t n = n_atoms[b];
    const int32_t e = n_bonds[b];
    // z and positions, replicated across conformers
    for (int32_t k = 0; k < K; ++k) {
      int32_t* zrow = z_out + ((int64_t)b * K + k) * N;
      std::memcpy(zrow, z_concat + atom_off, sizeof(int32_t) * n);
      float* prow = pos_out + (((int64_t)b * K + k) * N) * 3;
      const float* psrc = pos_concat + (atom_off * K + (int64_t)k * n) * 3;
      std::memcpy(prow, psrc, sizeof(float) * n * 3);
      for (int32_t i = n; i < N; ++i) {
        const float far = 1e4f + 10.0f * (i - n);
        prow[i * 3 + 0] = far;
        prow[i * 3 + 1] = far;
        prow[i * 3 + 2] = far;
      }
    }
    for (int32_t i = 0; i < n; ++i) atom_mask[(int64_t)b * N + i] = 1;
    std::memcpy(x2d_out + (int64_t)b * N * NF, x2d_concat + atom_off * NF,
                sizeof(int32_t) * n * NF);
    // dense symmetric bond adjacency + attributes
    for (int32_t t = 0; t < e; ++t) {
      const int32_t i = bonds_concat[(bond_off + t) * 2 + 0];
      const int32_t j = bonds_concat[(bond_off + t) * 2 + 1];
      bond_adj[((int64_t)b * N + i) * N + j] = 1;
      bond_adj[((int64_t)b * N + j) * N + i] = 1;
      const float* attr = battr_concat + (bond_off + t) * NBF;
      float* aij = bond_attr + (((int64_t)b * N + i) * N + j) * NBF;
      float* aji = bond_attr + (((int64_t)b * N + j) * N + i) * NBF;
      for (int32_t f = 0; f < NBF; ++f) {
        aij[f] = attr[f];
        aji[f] = attr[f];
      }
    }
    y_out[b] = y[b];
    mol_mask[b] = 1;
    atom_off += n;
    bond_off += e;
  }
}

}  // extern "C"
