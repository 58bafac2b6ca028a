// The cfconv kernels K1 and K2 for graphs of any atom count (sm_90a).
//
// Replaces the same Pallas TPU kernels as csrc/cfconv.cu
// (conan_fgw_tpu/ops/pallas/cfconv.py: _fused_fwd_impl / _kernel and
// _fused_bwd_impl / _bwd_kernel) above the 128 atoms that file's kernels
// hold. Its pipeline, arithmetic and edge order are cfconv.cu's, whose
// helpers this file includes: the same work items, tiles of ET edges, the
// 3xTF32 filter MLP on the tensor cores, the row sums on the tensor cores,
// the persistent grid cut by plan_tiles and K2's partials summed in a fixed
// order. So a graph above 128 atoms gets the result the small kernels would
// give it, and is bound by the same filter MLP (operation-bound).
//
// What differs is the state of a graph, which cfconv.cu sizes for MAXN:
// the positions, squared norms and mask (5 N floats), the item's edge list
// (4 R N: a K2 source may be the neighbour of every target) and the
// neighbour bits (N x ceil(N/32) words), 46 KB at N = 256 for K2. Here it
// has a run-time size. It sits in the block's dynamic shared memory beside
// the weights and tiles where it fits (to N = 352 or more at every width
// but K1's F = 256, to N = 224 there), else in a device scratch that the
// wrapper allocates, one slice a block, read through L1. The edge tiles'
// four arrays are staged into shared memory a tile at a time, so the
// products and gathers of a tile read shared memory as in cfconv.cu. K1
// runs one team of 8 warps a block at both widths (cfconv.cu's F = 128 K1
// runs two, whose state would not fit twice). The nearest-neighbour rank
// loops over the row's words at run time, recomputing a word's distances
// where cfconv.cu keeps them in registers, so that no per-lane array grows
// with N. cfconv_count_large_kernel keeps its state in dynamic shared
// memory, or in the scratch above about 1,270 atoms.

#define CFCONV_HELPERS_ONLY
#include "cfconv.cu"

namespace {

__host__ __device__ constexpr int words_of(int n) { return (n + 31) / 32; }

// cfconv_slabs of cfconv.cu's entry points (left out of this file).
int slabs_of(int F, int bwd) {
  if (F == 128) return 1;
  if (F == 256) return bwd ? Cfg<256, 16, true>::NS : Cfg<256, 16, false>::NS;
  return 0;
}

// A graph's state: pos (3 N), sq, mask, the item's edge list (ed, eg, ei,
// ej of nr N each) and the neighbour bits (N words of a row each).
__host__ __device__ constexpr size_t state_floats(int n, int nr) {
  return 5 * (size_t)n + 4 * (size_t)nr * n + (size_t)n * words_of(n);
}

// The count kernel's state: pos, sq, mask, the counts by line and the bits.
__host__ __device__ constexpr size_t count_floats(int n) {
  return 6 * (size_t)n + (size_t)n * words_of(n);
}

// Shared floats a block holds whatever N: the weights, the tiles, the
// staged edge tile and the 16 ints of cnt.
template <class C, bool BWD>
__host__ __device__ constexpr size_t fixed_floats() {
  return (size_t)C::WEIGHT_FLOATS + ET * C::SR + ET * C::SH + (BWD ? ET * C::SD : 0) +
         ET * C::SX + 4 * ET + 16;
}

template <class C, bool BWD, int NR>
bool state_in_smem(int n) {
  return (fixed_floats<C, BWD>() + state_floats(n, NR)) * sizeof(float) <= MAX_SMEM;
}

// The block's views: s with the graph's state (shared memory, or this
// block's slice of gstate), and v, the same with the edge arrays pointing
// at the staged tile.
template <class C, bool BWD, int NR>
__device__ void carve_large(float* p, float* gstate, int n, Smem& s, Smem& v) {
  s.w1 = reinterpret_cast<float2*>(p); p += C::KG * C::SW1;
  s.w2 = reinterpret_cast<float2*>(p); p += C::W2_ROWS * C::SW2;
  s.rbf = p; p += ET * C::SR;
  s.h = p; p += ET * C::SH;
  s.dwf = p; if (BWD) p += ET * C::SD;
  s.xs = p; p += ET * C::SX;
  v = s;
  v.ed = p; p += ET;
  v.eg = p; p += ET;
  v.ei = reinterpret_cast<int*>(p); p += ET;
  v.ej = reinterpret_cast<int*>(p); p += ET;
  s.cnt = v.cnt = reinterpret_cast<int*>(p); p += 16;
  float* st = gstate != nullptr ? gstate + blockIdx.x * state_floats(n, NR) : p;
  s.pos = st; st += 3 * n;
  s.sq = st; st += n;
  s.mask = st; st += n;
  s.ed = st; st += NR * n;
  s.eg = st; st += NR * n;
  s.ei = reinterpret_cast<int*>(st); st += NR * n;
  s.ej = reinterpret_cast<int*>(st); st += NR * n;
  s.bits = reinterpret_cast<uint32_t*>(st);
  v.pos = s.pos, v.sq = s.sq, v.mask = s.mask, v.bits = s.bits;
}

// row_bits_nearest with the row's words walked at run time: the distance
// of word w's candidate is recomputed for every word it is ranked against.
__device__ float nearest_candidate(const Smem& s, int n, float cutoff, int i, bool vi, int j) {
  if (j < n && j != i && vi && s.mask[j] > 0.5f) {
    const float dj = pair_dist(s.pos, s.sq, i, j);
    if (dj <= cutoff) return dj;
  }
  return INFINITY;
}

__device__ void row_bits_nearest_large(const Smem& s, int n, float cutoff, int cap, int r0,
                                       int r1) {
  const int warp = tid() >> 5, lane = tid() & 31;
  const int words = words_of(n);
  for (int i = r0 + warp; i < r1; i += THREADS / 32) {
    const bool vi = s.mask[i] > 0.5f;
    for (int w = 0; w < words; ++w) {
      const int j = 32 * w + lane;
      const float dj = nearest_candidate(s, n, cutoff, i, vi, j);
      int rank = 0;
      for (int w2 = 0; w2 < words; ++w2) {
        const float mine = w2 == w ? dj : nearest_candidate(s, n, cutoff, i, vi, 32 * w2 + lane);
        for (int src = 0; src < 32; ++src) {
          const float dk = __shfl_sync(0xffffffffu, mine, src);  // neighbour k = 32 w2 + src
          const int k = 32 * w2 + src;
          rank += dk < dj || (dk == dj && k < j);
        }
      }
      const uint32_t nb = __ballot_sync(0xffffffffu, dj < INFINITY && rank < cap);
      if (lane == 0) s.bits[(size_t)i * words + w] = nb;
    }
  }
}

// row_bits with a row stride of ceil(n/32) words.
__device__ void row_bits_large(const Smem& s, int n, float cutoff, int cap, int cap_mode, int r0,
                               int r1) {
  if (cap_mode) {
    row_bits_nearest_large(s, n, cutoff, cap, r0, r1);
    return;
  }
  const int warp = tid() >> 5, lane = tid() & 31;
  const uint32_t lt = (1u << lane) - 1u;
  const int words = words_of(n);
  for (int i = r0 + warp; i < r1; i += THREADS / 32) {
    const bool vi = s.mask[i] > 0.5f;
    int before = 0;  // candidates in earlier words
    for (int w = 0; w < words; ++w) {
      const int j = 32 * w + lane;
      bool within = false, cand = false;
      if (j < n) {
        const bool valid = vi && s.mask[j] > 0.5f;
        within = valid && pair_dist(s.pos, s.sq, i, j) <= cutoff;
        cand = within || (valid && i == j);
      }
      const uint32_t cb = __ballot_sync(0xffffffffu, cand);
      const int rank = before + __popc(cb & lt);
      const uint32_t nb = __ballot_sync(0xffffffffu, within && j != i && rank < cap + 1);
      if (lane == 0) s.bits[(size_t)i * words + w] = nb;
      before += __popc(cb);
    }
  }
}

template <bool SOURCE_MAJOR>
__device__ __forceinline__ uint32_t item_bits_large(const Smem& s, int n, int a, int w) {
  if (a >= n) return 0u;  // uniform across the warp
  const int words = words_of(n);
  if (!SOURCE_MAJOR) return s.bits[(size_t)a * words + w];
  const int i = 32 * w + (tid() & 31);
  const bool e = i < n && ((s.bits[(size_t)i * words + (a >> 5)] >> (a & 31)) & 1u);
  return __ballot_sync(0xffffffffu, e);
}

// build_edges over the run-time bit rows.
template <bool SOURCE_MAJOR, int NR>
__device__ int build_edges_large(const Smem& s, int n, float cutoff, int a0) {
  const int warp = tid() >> 5, lane = tid() & 31;
  const uint32_t lt = (1u << lane) - 1u;
  const int words = words_of(n);
  const int a = warp < NR ? a0 + warp : n;  // this warp's row (K1) or source (K2), if any
  int count = 0;
  for (int w = 0; w < words; ++w) count += __popc(item_bits_large<SOURCE_MAJOR>(s, n, a, w));
  if (lane == 0) s.cnt[warp] = count;
  team_sync();
  int base = 0, total = 0;
  for (int r = 0; r < R; ++r) {
    base += r < warp ? s.cnt[r] : 0;
    total += s.cnt[r];
  }
  for (int w = 0; w < words; ++w) {
    const uint32_t b = item_bits_large<SOURCE_MAJOR>(s, n, a, w);
    const int other = 32 * w + lane;
    if ((b >> lane) & 1u) {
      const int slot = base + __popc(b & lt);
      if (SOURCE_MAJOR) put_edge(s, slot, other, a, cutoff);
      else put_edge(s, slot, a, other, cutoff);
    }
    base += __popc(b);
  }
  team_sync();
  return total;
}

// Edges e0 .. e0+ne-1 of the item's list into the staged tile (slots >= ne
// are never read). Barriers on both sides: the last tile's readers are done.
__device__ __forceinline__ void stage_tile(const Smem& s, const Smem& v, int e0, int ne) {
  team_sync();
  const int k = tid();
  if (k < ne) {
    v.ed[k] = s.ed[e0 + k];
    v.eg[k] = s.eg[e0 + k];
    v.ei[k] = s.ei[e0 + k];
    v.ej[k] = s.ej[e0 + k];
  }
  team_sync();
}

template <bool SOURCE_MAJOR>
__global__ void __launch_bounds__(THREADS)
    cfconv_count_large_kernel(const float* __restrict__ pos, const float* __restrict__ mask, int n,
                              float cutoff, int cap, int cap_mode, float* gstate,
                              int* __restrict__ item_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* p = gstate != nullptr ? gstate + blockIdx.x * count_floats(n) : smem;
  const int words = words_of(n);
  Smem s = {};
  s.pos = p; p += 3 * n;
  s.sq = p; p += n;
  s.mask = p; p += n;
  int* col_s = reinterpret_cast<int*>(p); p += n;
  s.bits = reinterpret_cast<uint32_t*>(p);
  constexpr int NR = SOURCE_MAJOR ? R2 : R1;
  const int g = blockIdx.x, per_graph = (n + NR - 1) / NR;
  load_graph(s, pos, mask, g, n);
  row_bits_large(s, n, cutoff, cap, cap_mode, 0, n);
  team_sync();
  for (int a = tid(); a < n; a += THREADS) {  // edges of row a (K1) or source a (K2)
    int c = 0;
    if (SOURCE_MAJOR)
      for (int i = 0; i < n; ++i) c += (s.bits[(size_t)i * words + (a >> 5)] >> (a & 31)) & 1u;
    else
      for (int w = 0; w < words; ++w) c += __popc(s.bits[(size_t)a * words + w]);
    col_s[a] = c;
  }
  team_sync();
  for (int b = tid(); b < per_graph; b += THREADS) {
    int e = 0;
    for (int j = b * NR; j < min(b * NR + NR, n); ++j) e += col_s[j];
    item_tiles[g * per_graph + b] = (e + ET - 1) / ET;
  }
}

// ------------------------------------------------------------ K1
// cfconv_fwd_kernel with the run-time state and the staged tiles; one team.
template <int F, int KG, class T>
__global__ void __launch_bounds__(THREADS, 1)
    cfconv_fwd_large_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                            const T* __restrict__ x, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2, const int* __restrict__ item_tiles,
                            float* __restrict__ out, float* gstate, int G, int n, int gs,
                            float cutoff, int cap, int cap_mode) {
  using C = Cfg<F, KG, false>;
  constexpr int FO = C::FO;
  extern __shared__ __align__(16) float smem[];
  Smem s, v;
  carve_large<C, false, R1>(smem, gstate, n, s, v);
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int slab = blockIdx.x % C::NS, member = blockIdx.x / C::NS, members = gridDim.x / C::NS;
  const int o0 = slab * FO;  // this block's output filters
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const int per_graph = (n + R1 - 1) / R1;
  stage_weights<C::SC, C::SW1>(s.w1, w1, F, KG, gs, 0, 0);
  stage_weights<FO, C::SW2>(s.w2, w2, F, F, F, 0, o0);
  __syncthreads();
  const TileRun run = plan_tiles(s.cnt, item_tiles, G * per_graph, members, member);

  for (int item = run.k_lo, off = run.off_lo; item < run.k_hi; ++item) {
    const int g = item / per_graph, i0 = (item % per_graph) * R1;
    const int tiles = item_tiles[item];
    const int first = max(run.t_lo - off, 0), last = min(run.t_hi - off, tiles);  // its part
    off += tiles;
    if (first >= last) continue;  // a row block without edges: its rows stay zero
    team_sync();  // the previous item is done with the lists
    load_graph(s, pos, mask, g, n);
    row_bits_large(s, n, cutoff, cap, cap_mode, i0, min(i0 + R1, n));
    team_sync();
    const int E = build_edges_large<false, R1>(s, n, cutoff, i0);
    const T* xg = x + (size_t)g * n * F + o0;
    float rows[FO / 64][4] = {};
    for (int e0 = first * ET; e0 < min(E, last * ET); e0 += ET) {
      const int ne = min(ET, E - e0);
      stage_tile(s, v, e0, ne);
      float2 xv[FO / 32][2];  // x_j
      gather_rows<FO, F>(xg, v.ej, 0, ne, xv);
      rbf_tile<C>(v, 0, ne, gs, cutoff, step, coeff);
      team_sync();
      {
        float acc[1][C::SC / 32][4];
        layer1<C>(v, b1, acc);
        store_h<C>(v, acc);
      }
      team_sync();
      float acc[1][FO / 32][4];
      layer2<C>(v, b2 + o0, acc);
      // message W_e gate_e x_j into the message tile; padding edges give 0
      const int r0 = ew_row0(), c0 = ew_col0<FO>();
#pragma unroll
      for (int nt = 0; nt < FO / 32; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
          const float gate = e < ne ? v.eg[e] : 0.f;
          *reinterpret_cast<float2*>(v.xs + e * C::SX + c) =
              make_float2(acc[0][nt][2 * half] * gate * xv[nt][half].x,
                          acc[0][nt][2 * half + 1] * gate * xv[nt][half].y);
        }
      team_sync();
      scatter_rows<FO, C::SX>(v.xs, v.ei, i0, 0, ne, rows);
    }
    store_rows<FO, F>(rows, out + (size_t)g * n * F + o0, i0, R1, n, first > 0 || last < tiles);
  }
}

// ------------------------------------------------------------ K2
// cfconv_bwd_kernel with the run-time state and the staged tiles.
template <int F, int KG, class T>
__global__ void __launch_bounds__(THREADS, 1)
    cfconv_bwd_large_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                            const T* __restrict__ x, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2, const T* __restrict__ gout,
                            const int* __restrict__ item_tiles, float* __restrict__ dx,
                            float* __restrict__ partial, float* gstate, int G, int n, int gs,
                            float cutoff, int cap, int cap_mode) {
  using C = Cfg<F, KG, true>;
  constexpr int SC = C::SC;
  extern __shared__ __align__(16) float smem[];
  Smem s, v;
  carve_large<C, true, R2>(smem, gstate, n, s, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int slab = blockIdx.x % C::NS, member = blockIdx.x / C::NS, members = gridDim.x / C::NS;
  const int c0s = slab * SC;  // this block's channels of h
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const int per_graph = (n + R2 - 1) / R2;
  stage_weights<SC, C::SW1>(s.w1, w1, F, KG, gs, 0, c0s);
  stage_weights<F, C::SW2>(s.w2, w2, F, SC, SC, c0s, 0);
  const TileRun run = plan_tiles(s.cnt, item_tiles, G * per_graph, members, member);  // orders the weights too
  float* dxs = dx + (size_t)slab * G * n * F;

  constexpr int RG = SC / 32, CW = F / (8 / RG);
  constexpr int RG1 = SC / 16, KW = C::KG / (8 / RG1);
  float dw2[2][CW / 8][4], dw1t[1][KW / 8][4];
  zero(dw2);
  zero(dw1t);
  float db2 = 0.f, db1 = 0.f;  // db2 for threads < F (channel tid), db1 for the last SC threads
  const int db1_c = threadIdx.x - (THREADS - SC);

  for (int item = run.k_lo, off = run.off_lo, loaded = -1; item < run.k_hi; ++item) {
    const int g = item / per_graph, j0 = (item % per_graph) * R2;
    const int tiles = item_tiles[item];
    const int first = max(run.t_lo - off, 0), last = min(run.t_hi - off, tiles);  // its part
    off += tiles;
    if (first >= last) continue;  // an item without edges: its dx rows stay zero
    __syncthreads();
    if (g != loaded) {  // consecutive items of a graph share its neighbour bits
      load_graph(s, pos, mask, g, n);
      row_bits_large(s, n, cutoff, cap, cap_mode, 0, n);
      loaded = g;
    }
    __syncthreads();
    const int E = build_edges_large<true, R2>(s, n, cutoff, j0);
    const T* xg = x + (size_t)g * n * F;
    const T* gg = gout + (size_t)g * n * F;
    float rows[F / 64][4] = {};
    for (int e0 = first * ET; e0 < min(E, last * ET); e0 += ET) {
      const int ne = min(ET, E - e0);
      stage_tile(s, v, e0, ne);
      const int r0 = ew_row0(), c0 = ew_col0<F>();
      float2 gv[F / 32][2], xv[F / 32][2];  // g_i and x_j
      gather_rows<F, F>(gg, v.ei, 0, ne, gv);
      gather_rows<F, F>(xg, v.ej, 0, ne, xv);
      constexpr bool late_dw = F == 128;
      if constexpr (!late_dw) put_dw<C>(v, 0, ne, gv, xv);
      rbf_tile<C>(v, 0, ne, gs, cutoff, step, coeff);
      __syncthreads();
      float acc[1][SC / 32][4], sig[SC / 32][4];
      layer1<C>(v, b1 + c0s, acc);
#pragma unroll
      for (int nt = 0; nt < SC / 32; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sig[nt][r] = sigmoidf(acc[0][nt][r]);  // ssp'(pre)
      store_h<C>(v, acc);
      if constexpr (late_dw) put_dw<C>(v, 0, ne, gv, xv);
      __syncthreads();
      {
        float accw[1][F / 32][4];
        layer2<C>(v, slab == 0 ? b2 : nullptr, accw);
#pragma unroll
        for (int nt = 0; nt < F / 32; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
            float2* m = reinterpret_cast<float2*>(v.xs + e * C::SX + c);
            const float2 a = *m;
            *m = make_float2(accw[0][nt][2 * half] * a.x, accw[0][nt][2 * half + 1] * a.y);
          }
      }
      __syncthreads();
      scatter_rows<F, C::SX>(v.xs, v.ej, j0, 0, ne, rows);
      if (threadIdx.x < F)  // padding rows of the tile are zero
#pragma unroll
        for (int e = 0; e < ET; ++e) db2 += v.dwf[e * C::SD + threadIdx.x];
      zero(acc);
      warp_mma<1, SC / 32, F>(acc, F32Tile<C::SD, 1>{v.dwf}, PackedWT<C::SW2>{v.w2}, r0,
                              ew_col0<SC>());
      warp_mma<2, CW / 8, ET>(dw2, F32Tile<1, C::SH>{v.h}, F32Tile<1, C::SD>{v.dwf},
                              32 * (warp % RG), CW * (warp / RG));
      __syncthreads();  // the dx sums are done with the message tile
      {
        const int cs = ew_col0<SC>();
#pragma unroll
        for (int nt = 0; nt < SC / 32; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = r0 + g8 + 8 * half, c = cs + nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(v.xs + e * C::SX + c) =
                make_float2(acc[0][nt][2 * half] * sig[nt][2 * half],
                            acc[0][nt][2 * half + 1] * sig[nt][2 * half + 1]);
          }
      }
      __syncthreads();
      warp_mma<1, KW / 8, ET>(dw1t, F32Tile<1, C::SX>{v.xs}, F32Tile<1, C::SR>{v.rbf},
                              16 * (warp % RG1), KW * (warp / RG1));
      if (db1_c >= 0)
#pragma unroll
        for (int e = 0; e < ET; ++e) db1 += v.xs[e * C::SX + db1_c];
      __syncthreads();  // rbf and the dpre tile are rewritten by the next tile
    }
    store_rows<F, F>(rows, dxs + (size_t)g * n * F, j0, R2, n, first > 0 || last < tiles);
  }

  float* p = partial + (size_t)blockIdx.x * C::partial_floats(gs);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < CW / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 32 * (warp % RG) + 16 * mt + g8 + 8 * (r >> 1);
        const int c2 = CW * (warp / RG) + 8 * nt + 2 * t + (r & 1);
        p[c * F + c2] = dw2[mt][nt][r];
      }
#pragma unroll
  for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 16 * (warp % RG1) + g8 + 8 * (r >> 1), k = KW * (warp / RG1) + 8 * nt + 2 * t + (r & 1);
      if (k < gs) p[SC * F + k * SC + c] = dw1t[0][nt][r];
    }
  if (threadIdx.x < F) p[SC * F + gs * SC + SC + threadIdx.x] = db2;
  if (db1_c >= 0) p[SC * F + gs * SC + db1_c] = db1;
}

// The scratch of one launch, in floats: the count kernel's state where it
// does not fit in shared memory (G slices), then the main kernel's (blocks
// slices).
bool count_in_smem(int n) { return count_floats(n) * sizeof(float) <= MAX_SMEM; }

template <class C, bool BWD, int NR>
size_t scratch_floats(int G, int n, int blocks) {
  return (count_in_smem(n) ? 0 : (size_t)G * count_floats(n)) +
         (state_in_smem<C, BWD, NR>(n) ? 0 : (size_t)blocks * state_floats(n, NR));
}

template <bool SOURCE_MAJOR>
int count_large(const float* pos, const float* mask, int G, int N, float cutoff, int cap,
                int cap_mode, float* scratch, int* item_tiles, cudaStream_t st) {
  const bool smem = count_in_smem(N);
  const size_t bytes = smem ? count_floats(N) * sizeof(float) : 0;
  const int code = set_smem(cfconv_count_large_kernel<SOURCE_MAJOR>, MAX_SMEM);
  if (code != 0) return code;
  cfconv_count_large_kernel<SOURCE_MAJOR><<<G, THREADS, bytes, st>>>(
      pos, mask, N, cutoff, cap, cap_mode, smem ? nullptr : scratch, item_tiles);
  return (int)cudaGetLastError();
}

template <int F, int KG, class T>
int fwd_large(const float* pos, const float* mask, const T* x, const float* w1, const float* b1,
              const float* w2, const float* b2, T* out, float* out32, int* item_tiles,
              float* scratch, int G, int N, int Gs, float cutoff, int cap, int cap_mode,
              int blocks, cudaStream_t st) {
  using C = Cfg<F, KG, false>;
  constexpr bool direct = std::is_same<T, float>::value;  // f32 sums straight into out
  float* acc = direct ? reinterpret_cast<float*>(out) : out32;
  const size_t count = (size_t)G * N * F;
  cudaError_t err;
  if ((err = cudaMemsetAsync(acc, 0, count * sizeof(float), st)) != cudaSuccess) return (int)err;
  int code = count_large<false>(pos, mask, G, N, cutoff, cap, cap_mode, scratch, item_tiles, st);
  if (code != 0) return code;
  const bool smem = state_in_smem<C, false, R1>(N);
  float* gstate = smem ? nullptr : scratch + (count_in_smem(N) ? 0 : (size_t)G * count_floats(N));
  const size_t bytes = (fixed_floats<C, false>() + (smem ? state_floats(N, R1) : 0)) * sizeof(float);
  if ((code = set_smem(cfconv_fwd_large_kernel<F, KG, T>, MAX_SMEM)) != 0) return code;
  cfconv_fwd_large_kernel<F, KG, T><<<blocks, THREADS, bytes, st>>>(
      pos, mask, x, w1, b1, w2, b2, item_tiles, acc, gstate, G, N, Gs, cutoff, cap, cap_mode);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (!direct) return sum_parts<1, T>(acc, count, out, st);
  return 0;
}

template <int F, int KG, class T>
int bwd_large(const float* pos, const float* mask, const T* x, const float* w1, const float* b1,
              const float* w2, const float* b2, const T* gout, T* dx, float* dx_parts, float* dw1,
              float* db1, float* dw2, float* db2, float* partial, int* item_tiles, float* scratch,
              int G, int N, int Gs, float cutoff, int cap, int cap_mode, int blocks,
              cudaStream_t st) {
  using C = Cfg<F, KG, true>;
  constexpr bool direct = std::is_same<T, float>::value && C::NS == 1;  // dx written in place
  const size_t count = (size_t)G * N * F;
  float* parts = direct ? reinterpret_cast<float*>(dx) : dx_parts;
  cudaError_t err;
  if ((err = cudaMemsetAsync(parts, 0, C::NS * count * sizeof(float), st)) != cudaSuccess)
    return (int)err;
  int code = count_large<true>(pos, mask, G, N, cutoff, cap, cap_mode, scratch, item_tiles, st);
  if (code != 0) return code;
  const bool smem = state_in_smem<C, true, R2>(N);
  float* gstate = smem ? nullptr : scratch + (count_in_smem(N) ? 0 : (size_t)G * count_floats(N));
  const size_t bytes = (fixed_floats<C, true>() + (smem ? state_floats(N, R2) : 0)) * sizeof(float);
  if ((code = set_smem(cfconv_bwd_large_kernel<F, KG, T>, MAX_SMEM)) != 0) return code;
  cfconv_bwd_large_kernel<F, KG, T><<<blocks, THREADS, bytes, st>>>(
      pos, mask, x, w1, b1, w2, b2, gout, item_tiles, parts, partial, gstate, G, N, Gs, cutoff,
      cap, cap_mode);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = F * F + Gs * F + 2 * F;
  cfconv_reduce_kernel<F, KG><<<(total + 255) / 256, 256, 0, st>>>(partial, blocks, Gs, dw1, db1,
                                                                   dw2, db2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (!direct) return sum_parts<C::NS, T>(parts, count, dx, st);
  return 0;
}

}  // namespace

extern "C" {

// Floats of the device scratch that cfconv_fwd_large (bwd 0) or
// cfconv_bwd_large (bwd 1) needs at F filters for G graphs of N atoms on a
// grid of `blocks`: 0 where every state fits in shared memory.
size_t cfconv_large_scratch_floats(int F, int bwd, int G, int N, int blocks) {
  if (F == 128)
    return bwd ? scratch_floats<Cfg<128, 64, true>, true, R2>(G, N, blocks)
               : scratch_floats<Cfg<128, 64, false>, false, R1>(G, N, blocks);
  if (F == 256)
    return bwd ? scratch_floats<Cfg<256, 16, true>, true, R2>(G, N, blocks)
               : scratch_floats<Cfg<256, 16, false>, false, R1>(G, N, blocks);
  return 0;
}

// K1 for any N: cfconv_fwd's arguments and a scratch of
// cfconv_large_scratch_floats(F, 0, G, N, blocks) floats (may be null when
// that is 0).
int cfconv_fwd_large(const float* pos, const float* mask, const void* x, const float* w1,
                     const float* b1, const float* w2, const float* b2, void* out, float* out32,
                     int* item_tiles, float* scratch, int G, int N, int F, int Gs, float cutoff,
                     int cap, int cap_mode, int blocks, int dtype, void* stream) {
  if (!compiled(F, Gs) || blocks % slabs_of(F, 0) || !valid_modes(dtype, cap_mode) || N < 1)
    return (int)cudaErrorInvalidValue;
  const auto run = [&](auto tag) {
    using T = decltype(tag);
    const auto xt = static_cast<const T*>(x);
    const auto ot = static_cast<T*>(out);
    cudaStream_t st = (cudaStream_t)stream;
    if (F == 128)
      return fwd_large<128, 64, T>(pos, mask, xt, w1, b1, w2, b2, ot, out32, item_tiles, scratch, G,
                                   N, Gs, cutoff, cap, cap_mode, blocks, st);
    return fwd_large<256, 16, T>(pos, mask, xt, w1, b1, w2, b2, ot, out32, item_tiles, scratch, G,
                                 N, Gs, cutoff, cap, cap_mode, blocks, st);
  };
  if (dtype == 1) return run(__nv_bfloat16{});
  if (dtype == 2) return run(__half{});
  return run(0.f);
}

// K2 for any N: cfconv_bwd's arguments and a scratch of
// cfconv_large_scratch_floats(F, 1, G, N, blocks) floats.
int cfconv_bwd_large(const float* pos, const float* mask, const void* x, const float* w1,
                     const float* b1, const float* w2, const float* b2, const void* gout, void* dx,
                     float* dx_parts, float* dw1, float* db1, float* dw2, float* db2,
                     float* partial, int* item_tiles, float* scratch, int G, int N, int F, int Gs,
                     float cutoff, int cap, int cap_mode, int blocks, int dtype, void* stream) {
  if (!compiled(F, Gs) || blocks % slabs_of(F, 1) || !valid_modes(dtype, cap_mode) || N < 1)
    return (int)cudaErrorInvalidValue;
  const auto run = [&](auto tag) {
    using T = decltype(tag);
    const auto xt = static_cast<const T*>(x);
    const auto gt = static_cast<const T*>(gout);
    const auto dt = static_cast<T*>(dx);
    cudaStream_t st = (cudaStream_t)stream;
    if (F == 128)
      return bwd_large<128, 64, T>(pos, mask, xt, w1, b1, w2, b2, gt, dt, dx_parts, dw1, db1, dw2,
                                   db2, partial, item_tiles, scratch, G, N, Gs, cutoff, cap,
                                   cap_mode, blocks, st);
    return bwd_large<256, 16, T>(pos, mask, xt, w1, b1, w2, b2, gt, dt, dx_parts, dw1, db1, dw2,
                                 db2, partial, item_tiles, scratch, G, N, Gs, cutoff, cap, cap_mode,
                                 blocks, st);
  };
  if (dtype == 1) return run(__nv_bfloat16{});
  if (dtype == 2) return run(__half{});
  return run(0.f);
}

}  // extern "C"
