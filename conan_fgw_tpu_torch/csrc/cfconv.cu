// Fused SchNet continuous-filter convolution (cfconv) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of conan_fgw_tpu/ops/pallas/cfconv.py:
//   K1 cfconv_fwd  <- _fused_fwd_impl / _kernel      (forward messages)
//   K2 cfconv_bwd  <- _fused_bwd_impl / _bwd_kernel  (dx and filter-MLP grads)
//
// Per conformer graph: Gram-form distances, the valid & radius & capped
// neighbour gate with cosine envelope, the Gaussian RBF, the filter
// MLP W = ssp(rbf W1 + b1) W2 + b2 and m_i = sum_j W_ij gate_ij x_j. No
// (G, N, N, F) tensor reaches device memory: the edge pipeline runs per tile
// of ET edges in shared memory and registers.
//
// What bounds it on this card: the filter MLP, 2 (Gs F + F F) flops per edge
// forward and 4 Gs F + 6 F F backward, over 99% of the work; the bytes (pos,
// x, the cotangent, the weights) are a few MB. So it is operation-bound, and
// the five products of the MLP are dense products of edge tiles with the
// (Gs, F) and (F, F) weights: tensor-core work. They run on the tensor cores
// with mma.sync.m16n8k8 in TF32, each f32 operand split in two (a = a_big +
// a_small + O(2^-22 a)) and the product taken as a_small b_big + a_big
// b_small + a_big b_big with f32 sums (3xTF32): about 22 bits. One TF32
// pass keeps 11 and does not hold the 5e-4 contract with any margin; a
// three-term bf16 split (16 bits) holds it, but its rounding showed in the
// attention head's gradient at N = 64, where a softmax over 160 nearly equal
// conformers leaves a small residue of large terms. The elementwise parts
// (RBF, ssp, sigmoid, gate, the products with x and the cotangent) stay on
// the CUDA cores between the products. With 8 or 16 warps an SM, the
// products are latency-bound, not tensor-pipe-bound.
//
// Design:
// - Work items. K1: (graph, block of R1 = 4 target rows i), edges ordered
//   by (i, j). K2: (graph, block of R2 = 8 source atoms j), edges ordered by
//   (j, i). Each item owns its output rows (out_i for K1, dx_j for K2). A
//   team builds the graph's neighbour bits row by row with warp ballots (the
//   cap rank is a popcount prefix), then compacts the item's edges into a
//   dense list in shared memory. Only the last tile of an item carries
//   padding.
// - Teams of 8 warps work on one item at a time, in tiles of ET = 32 edges;
//   Gs is zero-padded to KG, a multiple of 16. The weights a block needs
//   stay in shared memory for its life, in f32 pairs along k; weights and
//   edge tiles are split as their fragments are loaded.
// - Row sums into out / dx: a sixth product on the tensor cores, the 0/1
//   selection of the item's rows times the message tile, accumulated over
//   the item's tiles in registers: fixed order, no branches.
// - Scheduling: a persistent grid of about one block per SM. A first small
//   kernel counts each item's tiles; each team then takes one contiguous run
//   of nearly equal length of the tile sequence, so an item may be computed
//   in two parts, added into the zeroed output (plan_tiles). The partition
//   depends only on the data, so every sum either kernel forms is the same
//   on every run.
// - K2 weight gradients: each block keeps its dW2 / dW1 partials in MMA
//   accumulators (registers) and db1 / db2 in registers, writes them to a
//   (P, .) scratch, and cfconv_reduce sums the P partials in a fixed order.
//   K1 and K2 are bit-identical run to run.
//
// Two widths are compiled (Cfg below):
// - F = 128 filters, Gs <= KG = 64: the regression model. Every block holds
//   all of W1 and W2. K1 runs two teams a block (16 warps an SM) that share
//   the weights; K2 needs more registers and shared memory and runs one.
// - F = 256 filters, Gs <= KG = 16: the classification model. W2 in f32 is
//   256 KiB, more than a block's 227 KB, so the blocks split it in
//   slabs. K1 splits the output filters in two slabs of 128: a block holds
//   all of W1 and the columns W2[:, slab], recomputes h = ssp(rbf W1 + b1)
//   for every edge (Gs F = 2,560 MACs an edge against F 128 = 32,768 for
//   its slab of the second product) and writes its own columns of out; one
//   team a block. K2 splits the input filters c of h in four slabs of 64: a
//   block holds W1[:, slab] and the rows W2[slab, :] and computes on its own
//   h[:, slab], dpre[:, slab] = (dW W2[slab, :]^T) * ssp'(pre[:, slab]),
//   dW1[:, slab] and dW2[slab, :] (64 x 256 partials: as many registers as
//   F = 128's 128 x 128). Only dx, a sum over c through W = h W2 + b2, needs
//   the four slabs' parts: each slab writes its own (G, N, F) part and
//   cfconv_sum_parts_kernel sums them in slab order. The edge list and the
//   gathers are built once per slab.
//
// Node features: x and the cotangent are f32, bf16 or f16 (the element
// type T of the kernels), as the Pallas kernels take bf16 x in a bf16 trunk
// (an f16 trunk, which the Pallas kernels refuse, takes the same route
// here). A bf16 or f16 element is widened to f32 as it is loaded and
// everything after is the f32 arithmetic above, so those variants compute
// exactly what the f32 one does on the widened inputs. Their out and dx are
// summed in an f32 scratch and rounded once to T, to nearest even
// (__float2bfloat16_rn, __float2half_rn, as XLA's convert rounds), by
// cfconv_sum_parts_kernel; the weight gradients stay f32 and are summed as
// in the f32 variant.
//
// The neighbour cap is a runtime argument (cap_mode), not a template flag,
// which would double the instantiations: 0 keeps torch-cluster's first
// candidates by index (the Pallas kernels' only rule), 1 the nearest ones
// (radius_graph_mask's cap_mode "nearest"). The rule is applied once per
// row when a row's neighbour bits are built, outside the edge tiles.
//
// Limits: F = 128 with 2 <= Gs <= 64, or F = 256 with 2 <= Gs <= 16.
// These kernels hold a graph's state in arrays sized for N <= 128 atoms
// (MAXN); csrc/cfconv_wgmma.cu runs every N above that, and includes this
// file for its helpers (with CFCONV_HELPERS_ONLY defined, which leaves out
// the entry points below).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ET = 32;        // edges per tile
constexpr int R1 = 4;         // rows per K1 work item
constexpr int R2 = 8;         // sources per K2 work item
constexpr int R = 8;          // the larger, for buffers
constexpr int MAXN = 128;     // atoms per graph
constexpr int NWORD = MAXN / 32;
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr float PI_F = 3.14159265358979323846f;
constexpr float LOG2_F = 0.69314718055994530942f;
static_assert(R1 <= R && R2 <= R && R <= THREADS / 32, "one warp per row / source of an item");

// What one kernel of one width holds. F filters, KG padded Gaussians.
// K1 (BWD false): a block computes FO = 128 output filters (its slab of
// NS = F / 128) from all SC = F channels of h. K2 (BWD true): a block
// computes all FO = F output filters' terms from its slab of SC channels of
// h (NS = F / SC slabs). Row strides (floats) of the shared tiles: a
// fragment reads element pairs (k, k+1) along a row as one 8-byte load at
// [g][2t] (conflict-free when stride % 32 is 8 or 24), or down a column as
// two loads at [2t][g] and [2t+1][g] (conflict-free when stride % 8 is 4).
// A tile read both ways takes the first; its column reads see 2-way
// conflicts. Packed weights hold pairs (float2), conflict-free for 8-byte
// reads when the pair stride % 16 is 4.
template <int F_, int KG_, bool BWD>
struct Cfg {
  static constexpr int F = F_, KG = KG_;
  static constexpr int SC = BWD && F == 256 ? 64 : F;  // channels of h a block computes
  static constexpr int FO = BWD ? F : 128;             // output filters a block computes
  static constexpr int NS = BWD ? F / SC : F / FO;     // slabs
  static constexpr int TEAMS = !BWD && F == 128 ? 2 : 1;
  static constexpr int SW1 = SC + 4;                   // W1[:, slab] pairs (KG/2 rows)
  static constexpr int W2_ROWS = BWD ? SC : F;         // W2[rows, cols] staged
  static constexpr int SW2 = FO + 4;                   // W2 pairs (W2_ROWS/2 rows)
  static constexpr int SR = KG + 8;   // rbf  [e][k]: P1 A by row, P5 B by column
  static constexpr int SH = SC + 8;   // h    [e][c]: P2 A by row, P4 A by column
  static constexpr int SD = F + 8;    // dWf  [e][c]: P3 A by row, P4 B by column (K2)
  static constexpr int SX = FO + 4;   // msg / dx message / dpre [e][c]: row sums B, P5 A by column
  static constexpr int WEIGHT_FLOATS = KG * SW1 + W2_ROWS * SW2;
  static constexpr int TEAM_FLOATS = ET * SR + ET * SH + (BWD ? ET * SD : 0) + ET * SX + 5 * MAXN +
                                     4 * R * MAXN + MAXN * NWORD + 16;
  static constexpr size_t SMEM = (size_t)(WEIGHT_FLOATS + TEAMS * TEAM_FLOATS) * sizeof(float);
  // K2's partials per block: dW2[slab, :] (SC x F), dW1[:, slab] (gs x SC),
  // db1[slab] (SC), db2 (F)
  __host__ __device__ static constexpr int partial_floats(int gs) { return SC * F + gs * SC + SC + F; }
  static_assert(F % 128 == 0 && KG % 16 == 0 && SC % 64 == 0, "the warp tilings below");
  static_assert(SMEM <= MAX_SMEM, "shared memory of one block");
};

// A team is THREADS threads (8 warps) that work on one item at a time with
// their own shared buffers and barrier; K1 at F = 128 runs two teams a block,
// which share the block's copy of the weights.
__device__ __forceinline__ int tid() { return threadIdx.x % THREADS; }
__device__ __forceinline__ int team() { return threadIdx.x / THREADS; }
__device__ __forceinline__ void team_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team()), "r"(THREADS) : "memory");
}

// The elementwise functions use the accurate expf / log1pf: the fast
// __expf errs by about |x| 2^-24 of its result (the rounded x log2 e),
// more than the 3xTF32 products leave, and a step whose gradient amplifies
// rounding (the attention head at N = 64) showed it.
__device__ __forceinline__ float ssp(float x) {
  // softplus(x) - log 2, stable for large |x|
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - LOG2_F;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Squared norm and Gram-form distance with a fixed operation order, so that
// dist(i, j) == dist(j, i) bit for bit.
__device__ __forceinline__ float sqnorm(const float* p) {
  return fmaf(p[2], p[2], fmaf(p[1], p[1], __fmul_rn(p[0], p[0])));
}

__device__ __forceinline__ float pair_dist(const float* pos_s, const float* sq_s, int i, int j) {
  const float* a = pos_s + 3 * i;
  const float* b = pos_s + 3 * j;
  float dot = fmaf(a[2], b[2], fmaf(a[1], b[1], __fmul_rn(a[0], b[0])));
  float d2 = __fsub_rn(__fadd_rn(sq_s[i], sq_s[j]), __fmul_rn(2.f, dot));
  return sqrtf(fmaxf(d2, 1e-12f));
}

// ------------------------------------------------------------ tensor cores
// The split: x = big + small + O(2^-22 x), big = tf32(x) and small =
// tf32(x - big), both rounded as cvt.rna.tf32.f32 rounds (to nearest, ties
// away from zero) on the bits: add half of the 13 dropped bits, clear them.
// Two integer instructions, no conversion. x - big is exact in f32. A NaN
// such as 0x7fffffff would carry into the sign bit; the operands here are
// finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Elements p[0] and p[S] (consecutive k).
template <int S>
__device__ __forceinline__ float2 load_pair(const float* p) {
  if constexpr (S == 1) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return make_float2(p[0], p[S]);
  }
}

// Operand loaders for warp_mma: load(r, k) gives elements (r, k) and
// (r, k+1) along the product's k, k even; r is the row m of A or the
// column n of B.
// F32Tile: an f32 edge tile, element (r, k) at p[r*RS + k*KS].
template <int RS, int KS>
struct F32Tile {
  const float* p;
  __device__ __forceinline__ float2 load(int r, int k) const { return load_pair<KS>(p + r * RS + k * KS); }
};
// Weights staged as pairs: p[(k/2)*SWP + n] holds W(k, n), W(k+1, n).
// PackedW reads B(k, n) = W(k, n) in one load; PackedWT reads B(k, n) =
// W(n, k) from the halves of two entries.
template <int SWP>
struct PackedW {
  const float2* p;
  __device__ __forceinline__ float2 load(int n, int k) const { return p[(k >> 1) * SWP + n]; }
};
template <int SWP>
struct PackedWT {
  const float2* p;
  __device__ __forceinline__ float2 load(int n, int k) const {
    const float2 a = p[(n >> 1) * SWP + k], b = p[(n >> 1) * SWP + k + 1];
    return (n & 1) ? make_float2(a.y, b.y) : make_float2(a.x, b.x);  // n's half of each pair
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp adds A (rows m0 .. m0 + MT*16) times B (columns n0 .. n0 + NT*8)
// over k < K (a multiple of 8) to acc with the three-term TF32 split
// a b ~ a_small b_big + a_big b_small + a_big b_big (3xTF32). Each k-step of
// 8 gives lane t the pair k0 + 2t, k0 + 2t + 1 at the fragment's columns t
// and t + 4 of A and rows t and t + 4 of B: the same permutation of k on
// both sides, so the product is unchanged and every operand is one 8-byte
// pair. Accumulator layout (mma.sync): acc[mt][nt][r] is row m0 + mt*16 + g
// + 8*(r>>1), column n0 + nt*8 + 2t + (r&1), with g = lane/4, t = lane%4.
template <int MT, int NT, int K, class LA, class LB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const LA& A, const LB& B,
                                         int m0, int n0) {
  static_assert(K % 8 == 0, "mma.m16n8k8 steps");
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int k = k0 + 2 * t;
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + mt * 16 + g;
      const float2 top = A.load(m, k), bottom = A.load(m + 8, k);
      split_tf32(top.x, ab[mt][0], as[mt][0]);
      split_tf32(bottom.x, ab[mt][1], as[mt][1]);
      split_tf32(top.y, ab[mt][2], as[mt][2]);
      split_tf32(bottom.y, ab[mt][3], as[mt][3]);
    }
    if constexpr (MT * NT <= 4) {
      // few accumulators: the three passes one after another over all of
      // them, so that consecutive mma do not wait on each other's sums
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v = B.load(n0 + nt * 8 + g, k);
        split_tf32(v.x, bb[nt][0], bs[nt][0]);
        split_tf32(v.y, bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb[2], bs[2];
        const float2 v = B.load(n0 + nt * 8 + g, k);
        split_tf32(v.x, bb[0], bs[0]);
        split_tf32(v.y, bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(acc[mt][nt], as[mt], bb);
          mma_tf32(acc[mt][nt], ab[mt], bs);
          mma_tf32(acc[mt][nt], ab[mt], bb);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
}

// ------------------------------------------------------------ shared memory
struct Smem {
  float2* w1;     // KG/2 x SW1, pairs (PackedW)
  float2* w2;     // W2_ROWS/2 x SW2
  float* rbf;     // ET x SR
  float* h;       // ET x SH
  float* dwf;     // ET x SD (K2 only)
  float* xs;      // ET x SX
  float* pos;     // 3 MAXN
  float* sq;      // MAXN
  float* mask;    // MAXN
  float* ed;      // R MAXN  edge distance
  float* eg;      // R MAXN  edge gate
  int* ei;        // R MAXN  edge target i
  int* ej;        // R MAXN  edge source j
  uint32_t* bits; // MAXN x NWORD neighbour bits: bit j of row i = "j is a source for i"
  int* cnt;       // 16: the item's R per-row / per-source edge counts;
                  // plan_tiles' scratch before the first item
};

// The calling thread's view: the shared weights, then its team's buffers.
template <class C, bool BWD>
__device__ Smem carve(float* p) {
  Smem s;
  s.w1 = reinterpret_cast<float2*>(p); p += C::KG * C::SW1;
  s.w2 = reinterpret_cast<float2*>(p); p += C::W2_ROWS * C::SW2;
  p += team() * C::TEAM_FLOATS;
  s.rbf = p; p += ET * C::SR;
  s.h = p; p += ET * C::SH;
  s.dwf = p; if (BWD) p += ET * C::SD;
  s.xs = p; p += ET * C::SX;
  s.pos = p; p += 3 * MAXN;
  s.sq = p; p += MAXN;
  s.mask = p; p += MAXN;
  s.ed = p; p += R * MAXN;
  s.eg = p; p += R * MAXN;
  s.ei = reinterpret_cast<int*>(p); p += R * MAXN;
  s.ej = reinterpret_cast<int*>(p); p += R * MAXN;
  s.bits = reinterpret_cast<uint32_t*>(p); p += MAXN * NWORD;
  s.cnt = reinterpret_cast<int*>(p);
  return s;
}

// Stages rows [row0, row0 + rows) and columns [col0, col0 + COLS) of W (row
// stride ld; rows >= valid are zero) in pairs along its rows:
// dst[(k/2)*SWP + n] = W(row0 + k, col0 + n), W(row0 + k + 1, col0 + n).
// Done once per block; fragment loads split them as they split edge tiles.
template <int COLS, int SWP>
__device__ void stage_weights(float2* dst, const float* w, int ld, int rows, int valid, int row0,
                              int col0) {
  for (int idx = threadIdx.x; idx < rows / 2 * COLS; idx += blockDim.x) {
    const int k = 2 * (idx / COLS), n = idx % COLS;
    const float a = k < valid ? __ldg(w + (size_t)(row0 + k) * ld + col0 + n) : 0.f;
    const float b = k + 1 < valid ? __ldg(w + (size_t)(row0 + k + 1) * ld + col0 + n) : 0.f;
    dst[(k / 2) * SWP + n] = make_float2(a, b);
  }
}

__device__ void load_graph(const Smem& s, const float* pos, const float* mask, int g, int n) {
  for (int a = tid(); a < 3 * n; a += THREADS) s.pos[a] = pos[(size_t)g * n * 3 + a];
  for (int a = tid(); a < n; a += THREADS) s.mask[a] = mask[(size_t)g * n + a];
  team_sync();
  for (int a = tid(); a < n; a += THREADS) s.sq[a] = sqnorm(s.pos + 3 * a);
  team_sync();
}

// Neighbour bits of rows [r0, r1) under the nearest rule: j is kept when
// it is within the cutoff, is not i, and fewer than cap other such
// neighbours k have (d_k, k) < (d_j, j), ties going to the lower index as a
// stable argsort orders them. One warp per row; lane l holds the distances
// of j = l, l + 32, l + 64, l + 96 (infinity where j is no neighbour), and
// each rank is a count over the row's values, shuffled lane by lane.
__device__ void row_bits_nearest(const Smem& s, int n, float cutoff, int cap, int r0, int r1) {
  const int warp = tid() >> 5, lane = tid() & 31;
  const int words = (n + 31) >> 5;
  for (int i = r0 + warp; i < r1; i += THREADS / 32) {
    const bool vi = s.mask[i] > 0.5f;
    float d[NWORD];
    int rank[NWORD];
#pragma unroll
    for (int w = 0; w < NWORD; ++w) {
      const int j = 32 * w + lane;
      d[w] = INFINITY;
      rank[w] = 0;
      if (j < n && j != i && vi && s.mask[j] > 0.5f) {
        const float dj = pair_dist(s.pos, s.sq, i, j);
        if (dj <= cutoff) d[w] = dj;
      }
    }
#pragma unroll
    for (int w2 = 0; w2 < NWORD; ++w2) {
      if (w2 >= words) break;  // uniform across the warp
      for (int src = 0; src < 32; ++src) {
        const float dk = __shfl_sync(0xffffffffu, d[w2], src);  // neighbour k = 32 w2 + src
        const int k = 32 * w2 + src;
#pragma unroll
        for (int w = 0; w < NWORD; ++w) rank[w] += dk < d[w] || (dk == d[w] && k < 32 * w + lane);
      }
    }
#pragma unroll
    for (int w = 0; w < NWORD; ++w) {
      const uint32_t nb = __ballot_sync(0xffffffffu, d[w] < INFINITY && rank[w] < cap);
      if (w < words && lane == 0) s.bits[i * NWORD + w] = nb;
    }
  }
}

// Neighbour bits of rows [r0, r1), one warp per row: torch-cluster's radius
// graph with the first-(cap+1)-candidates-by-index rule (self included as a
// candidate, then dropped; cap_mode 0), or the nearest rule
// (row_bits_nearest; cap_mode 1). The rank of candidate j is a popcount
// prefix of the row's candidate ballots.
__device__ void row_bits(const Smem& s, int n, float cutoff, int cap, int cap_mode, int r0,
                         int r1) {
  if (cap_mode) {
    row_bits_nearest(s, n, cutoff, cap, r0, r1);
    return;
  }
  const int warp = tid() >> 5, lane = tid() & 31;
  const uint32_t lt = (1u << lane) - 1u;
  const int words = (n + 31) >> 5;
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
      if (lane == 0) s.bits[i * NWORD + w] = nb;
      before += __popc(cb);
    }
  }
}

// Appends edge (i, j) of graph slot `pos` to the item's list.
__device__ __forceinline__ void put_edge(const Smem& s, int pos, int i, int j, float cutoff) {
  const float d = pair_dist(s.pos, s.sq, i, j);
  s.ei[pos] = i;
  s.ej[pos] = j;
  s.ed[pos] = d;
  s.eg[pos] = 0.5f * (cosf(d * PI_F / cutoff) + 1.f);
}

// Word w of the item's neighbour bits for row (K1) or source (K2) a: the
// sources j of row a, or the targets i whose list holds source a.
template <bool SOURCE_MAJOR>
__device__ __forceinline__ uint32_t item_bits(const Smem& s, int n, int a, int w) {
  if (a >= n) return 0u;  // uniform across the warp
  if (!SOURCE_MAJOR) return s.bits[a * NWORD + w];
  const int i = 32 * w + (tid() & 31);
  const bool e = i < n && ((s.bits[i * NWORD + (a >> 5)] >> (a & 31)) & 1u);
  return __ballot_sync(0xffffffffu, e);
}

// Compacts the item's edges. Target-major (K1): rows i in [a0, a0+NR), each
// row's sources j ascending. Source-major (K2): sources j in [a0, a0+NR),
// each source's targets i ascending. One warp per row / source; its slot is
// the sum of the counts before it plus a popcount prefix of its ballots.
// Returns the item's edge count. Needs row_bits of the rows it reads.
template <bool SOURCE_MAJOR, int NR>
__device__ int build_edges(const Smem& s, int n, float cutoff, int a0) {
  const int warp = tid() >> 5, lane = tid() & 31;
  const uint32_t lt = (1u << lane) - 1u;
  const int words = (n + 31) >> 5;
  const int a = warp < NR ? a0 + warp : n;  // this warp's row (K1) or source (K2), if any
  int count = 0;
  for (int w = 0; w < words; ++w) count += __popc(item_bits<SOURCE_MAJOR>(s, n, a, w));
  if (lane == 0) s.cnt[warp] = count;
  team_sync();
  int base = 0, total = 0;
  for (int r = 0; r < R; ++r) {
    base += r < warp ? s.cnt[r] : 0;
    total += s.cnt[r];
  }
  for (int w = 0; w < words; ++w) {
    const uint32_t b = item_bits<SOURCE_MAJOR>(s, n, a, w);
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

// RBF tile [e][k] of edges e0 .. e0+ne-1; padding edges and k >= gs are 0.
// The centres and the order of operations are torch.linspace's and
// gaussian_smearing's: the lower half k step, the upper half cutoff - (gs -
// 1 - k) step; exp(coeff (d - mu)^2).
template <class C>
__device__ void rbf_tile(const Smem& s, int e0, int ne, int gs, float cutoff, float step,
                         float coeff) {
  for (int idx = tid(); idx < ET * C::KG; idx += THREADS) {
    const int e = idx / C::KG, k = idx % C::KG;
    float v = 0.f;
    if (e < ne && k < gs) {
      const float mu = k < gs / 2 ? step * k : cutoff - step * (gs - 1 - k);
      const float diff = s.ed[e0 + e] - mu;
      v = expf(coeff * (diff * diff));
    }
    s.rbf[e * C::SR + k] = v;
  }
}

// Warp tiling of an (ET x W) edge-by-channel product: warp w takes edge
// rows 16 (w % 2) .. +15 and channels (W/4) (w / 2) .. +W/4-1, W/32 mma
// columns of 8.
__device__ __forceinline__ int ew_row0() { return 16 * ((tid() >> 5) & 1); }
template <int W>
__device__ __forceinline__ int ew_col0() { return (W / 4) * (tid() >> 6); }

// Adds the bias b (indexed by the tile's channel) to an ew accumulator.
template <int W>
__device__ __forceinline__ void add_bias(const float* b, float (&acc)[1][W / 32][4]) {
  const int c0 = ew_col0<W>(), t = tid() & 3;
#pragma unroll
  for (int nt = 0; nt < W / 32; ++nt) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c0 + nt * 8 + 2 * t));
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[0][nt][r] += (r & 1) ? bb.y : bb.x;
  }
}

// P1: pre = rbf W1[:, slab] + b1[slab] into acc (SC channels).
template <class C>
__device__ __forceinline__ void layer1(const Smem& s, const float* b1,
                                       float (&acc)[1][C::SC / 32][4]) {
  zero(acc);
  warp_mma<1, C::SC / 32, C::KG>(acc, F32Tile<C::SR, 1>{s.rbf}, PackedW<C::SW1>{s.w1}, ew_row0(),
                                 ew_col0<C::SC>());
  add_bias<C::SC>(b1, acc);
}

// h = ssp(pre) into the h tile.
template <class C>
__device__ __forceinline__ void store_h(const Smem& s, const float (&acc)[1][C::SC / 32][4]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const int r0 = ew_row0(), c0 = ew_col0<C::SC>();
#pragma unroll
  for (int nt = 0; nt < C::SC / 32; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = r0 + g + 8 * half, c = c0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(s.h + e * C::SH + c) =
          make_float2(ssp(acc[0][nt][2 * half]), ssp(acc[0][nt][2 * half + 1]));
    }
}

// Elements c, c+1 of a node-feature row, widened to f32.
__device__ __forceinline__ float2 load_feature_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_feature_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load_feature_pair(const __half* p) {
  return __half22float2(__ldg(reinterpret_cast<const __half2*>(p)));
}

// Rows key[e] of a graph's (N, ld) tensor, columns of an (ET x W) tile, at
// this thread's fragment positions of the edge tile (edge e, channels c,
// c+1); 0 for padding edges. Issued a phase before the values are used, so
// the loads' latency hides behind a product.
template <int W, int LD, class T>
__device__ __forceinline__ void gather_rows(const T* base, const int* key, int e0, int ne,
                                            float2 (&v)[W / 32][2]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const int r0 = ew_row0(), c0 = ew_col0<W>();
#pragma unroll
  for (int nt = 0; nt < W / 32; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = r0 + g + 8 * half, c = c0 + nt * 8 + 2 * t;
      v[nt][half] = e < ne ? load_feature_pair(base + (size_t)key[e0 + e] * LD + c)
                           : make_float2(0.f, 0.f);
    }
}

// dW_e = gate_e g_i x_j, the filter's cotangent, into the dW tile; gate_e
// g_i waits in the message tile for the dx message (this thread's own
// slots of the ew tiling over F channels).
template <class C>
__device__ __forceinline__ void put_dw(const Smem& s, int e0, int ne,
                                       const float2 (&gv)[C::F / 32][2],
                                       const float2 (&xv)[C::F / 32][2]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const int r0 = ew_row0(), c0 = ew_col0<C::F>();
#pragma unroll
  for (int nt = 0; nt < C::F / 32; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = r0 + g + 8 * half, c = c0 + nt * 8 + 2 * t;
      const float gate = e < ne ? s.eg[e0 + e] : 0.f;
      const float2 a = make_float2(gate * gv[nt][half].x, gate * gv[nt][half].y), b = xv[nt][half];
      *reinterpret_cast<float2*>(s.dwf + e * C::SD + c) = make_float2(a.x * b.x, a.y * b.y);
      *reinterpret_cast<float2*>(s.xs + e * C::SX + c) = a;
    }
}

// P2: W = h W2[slab rows, slab columns] (+ b2) into acc, FO channels; b2 null
// adds no bias (K2's slabs after the first).
template <class C>
__device__ __forceinline__ void layer2(const Smem& s, const float* b2,
                                       float (&acc)[1][C::FO / 32][4]) {
  zero(acc);
  warp_mma<1, C::FO / 32, C::SC>(acc, F32Tile<C::SH, 1>{s.h}, PackedW<C::SW2>{s.w2}, ew_row0(),
                                 ew_col0<C::FO>());
  if (b2 != nullptr) add_bias<C::FO>(b2, acc);
}

// Row sums of the item on the tensor cores: rows[r][c] += sum_e S[r][e]
// tile[e][c] over the tile's edges, with the selection S[r][e] = 1 where
// edge e's key (target i for K1, source j for K2) is key0 + r, r < R. S is
// exact in TF32, so two passes (tile big and small) suffice; k runs over
// the edges in the pairs of warp_mma. Warp w owns channels (W/8) w ..
// +W/8-1; acc rows g (r = 0, 1) are the item's rows, rows g + 8 stay zero.
// Fixed order, no atomics.
template <int W, int SX>
__device__ __forceinline__ void scatter_rows(const float* xs, const int* key, int key0, int e0,
                                             int ne, float (&rows)[W / 64][4]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const float* tile = xs + (W / 8) * (tid() >> 5);
  constexpr uint32_t ONE = 0x3f800000u;  // 1.0f
#pragma unroll
  for (int k0 = 0; k0 < ET; k0 += 8) {
    const int e = k0 + 2 * t;
    uint32_t a[4] = {0u, 0u, 0u, 0u};  // rows g + 8 (a[1], a[3]) select nothing
    a[0] = e < ne && key[e0 + e] - key0 == g ? ONE : 0u;
    a[2] = e + 1 < ne && key[e0 + e + 1] - key0 == g ? ONE : 0u;
#pragma unroll
    for (int nt = 0; nt < W / 64; ++nt) {
      const float2 v = load_pair<SX>(tile + e * SX + nt * 8 + g);
      uint32_t bb[2], bs[2];
      split_tf32(v.x, bb[0], bs[0]);
      split_tf32(v.y, bb[1], bs[1]);
      mma_tf32(rows[nt], a, bs);
      mma_tf32(rows[nt], a, bb);
    }
  }
}

// Writes the item's rows key0 .. key0+nr-1 (those below n) of dst (N, LD),
// columns of the W channels of the row sums, or adds them to dst when the
// item is computed in two parts.
template <int W, int LD>
__device__ __forceinline__ void store_rows(const float (&rows)[W / 64][4], float* dst, int key0,
                                           int nr, int n, bool part) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  if (g >= nr || key0 + g >= n) return;
#pragma unroll
  for (int nt = 0; nt < W / 64; ++nt) {
    float* p = dst + (size_t)(key0 + g) * LD + (W / 8) * (tid() >> 5) + nt * 8 + 2 * t;
    if (part) {
      atomicAdd(p, rows[nt][0]);
      atomicAdd(p + 1, rows[nt][1]);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(rows[nt][0], rows[nt][1]);
    }
  }
}

// ------------------------------------------------------------ balance
// cfconv_count_kernel gives each item (graph-major order, k = g * per_graph
// + b) its exact tile count. plan_tiles cuts the items' tiles, in that order,
// into one contiguous run of nearly equal length per team. An item cut
// between two teams is computed in two parts whose output rows are added
// atomically to the zeroed output: two addends onto zero give the same sum
// in either order. Runs are at least as long as the longest item (fewer
// teams work if need be), so no item spans three teams, and every sum the
// kernels form is the same from run to run. With slabs, each slab's teams
// cut the same sequence among themselves and write their own columns (K1)
// or their own part of dx (K2), so the rule holds per slab.
template <bool SOURCE_MAJOR>
__global__ void __launch_bounds__(THREADS)
    cfconv_count_kernel(const float* __restrict__ pos, const float* __restrict__ mask, int n,
                        float cutoff, int cap, int cap_mode, int* __restrict__ item_tiles) {
  __shared__ float pos_s[3 * MAXN], sq_s[MAXN], mask_s[MAXN];
  __shared__ uint32_t bits_s[MAXN * NWORD];
  __shared__ int col_s[MAXN];
  Smem s = {};
  s.pos = pos_s;
  s.sq = sq_s;
  s.mask = mask_s;
  s.bits = bits_s;
  constexpr int NR = SOURCE_MAJOR ? R2 : R1;
  const int g = blockIdx.x, per_graph = (n + NR - 1) / NR;
  load_graph(s, pos, mask, g, n);
  row_bits(s, n, cutoff, cap, cap_mode, 0, n);
  team_sync();
  for (int a = tid(); a < n; a += THREADS) {  // edges of row a (K1) or source a (K2)
    int c = 0;
    if (SOURCE_MAJOR)
      for (int i = 0; i < n; ++i) c += (s.bits[i * NWORD + (a >> 5)] >> (a & 31)) & 1u;
    else
      for (int w = 0; w < (n + 31) / 32; ++w) c += __popc(s.bits[a * NWORD + w]);
    col_s[a] = c;
  }
  team_sync();
  for (int b = tid(); b < per_graph; b += THREADS) {
    int e = 0;
    for (int j = b * NR; j < min(b * NR + NR, n); ++j) e += col_s[j];
    item_tiles[g * per_graph + b] = (e + ET - 1) / ET;
  }
}

// A team's run: tiles [t_lo, t_hi) of the global tile sequence, which fall
// in items [k_lo, k_hi); item k_lo starts at tile off_lo.
struct TileRun {
  int t_lo, t_hi, k_lo, k_hi, off_lo;
};

// The run of team `me` of `teams`; red: 16 ints of the team's shared scratch.
__device__ TileRun plan_tiles(int* red, const int* __restrict__ item_tiles, int items, int teams,
                              int me) {
  const int warp = tid() >> 5, lane = tid() & 31;
  int total = 0, longest = 0;
  for (int k0 = 0; k0 < items; k0 += THREADS) {
    const int k = k0 + tid();
    int c = k < items ? item_tiles[k] : 0, m = c;
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, o);
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (lane == 0) red[warp] = c, red[8 + warp] = m;
    team_sync();
    for (int w = 0; w < THREADS / 32; ++w) total += red[w], longest = max(longest, red[8 + w]);
    team_sync();
  }
  const long long P = longest > 0 ? max(1, min(teams, total / longest)) : 1;
  TileRun run;
  run.t_lo = (int)(min((long long)me, P) * total / P);
  run.t_hi = (int)(min((long long)me + 1, P) * total / P);
  if (tid() == 0) red[8] = 0, red[9] = 0, red[10] = 0;  // an empty run: no items
  int start = 0;  // tiles of the items before this chunk
  for (int k0 = 0; k0 < items; k0 += THREADS) {
    team_sync();
    const int k = k0 + tid();
    const int c = k < items ? item_tiles[k] : 0;
    int incl = c;  // inclusive scan of the chunk
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) red[warp] = incl;
    team_sync();
    int off = start + incl - c;
    for (int w = 0; w < THREADS / 32; ++w) {
      off += w < warp ? red[w] : 0;
      start += red[w];
    }
    // the items holding the run's first and last tiles, one writer each
    if (c > 0 && run.t_lo < run.t_hi && off <= run.t_lo && run.t_lo < off + c)
      red[8] = k, red[10] = off;
    if (c > 0 && run.t_lo < run.t_hi && off < run.t_hi && run.t_hi <= off + c) red[9] = k + 1;
  }
  team_sync();
  run.k_lo = red[8];
  run.k_hi = red[9];
  run.off_lo = red[10];
  return run;
}

// ------------------------------------------------------------ K1
// Block b computes slab b % NS of the output filters; the blocks of a slab
// and their teams share out its tiles. out is f32 (the bf16 variant's
// scratch).
template <int F, int KG, class T>
__global__ void __launch_bounds__(Cfg<F, KG, false>::TEAMS * THREADS, 1)
    cfconv_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                      const T* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const int* __restrict__ item_tiles,
                      float* __restrict__ out, int G, int n, int gs, float cutoff, int cap,
                      int cap_mode) {
  using C = Cfg<F, KG, false>;
  constexpr int FO = C::FO;
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<C, false>(smem);
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int slab = blockIdx.x % C::NS, member = blockIdx.x / C::NS, members = gridDim.x / C::NS;
  const int o0 = slab * FO;  // this block's output filters
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const int per_graph = (n + R1 - 1) / R1;
  stage_weights<C::SC, C::SW1>(s.w1, w1, F, KG, gs, 0, 0);
  stage_weights<FO, C::SW2>(s.w2, w2, F, F, F, 0, o0);
  __syncthreads();
  const TileRun run = plan_tiles(s.cnt, item_tiles, G * per_graph, C::TEAMS * members,
                                 C::TEAMS * member + team());

  for (int item = run.k_lo, off = run.off_lo; item < run.k_hi; ++item) {
    const int g = item / per_graph, i0 = (item % per_graph) * R1;
    const int tiles = item_tiles[item];
    const int first = max(run.t_lo - off, 0), last = min(run.t_hi - off, tiles);  // its part
    off += tiles;
    if (first >= last) continue;  // a row block without edges: its rows stay zero
    team_sync();  // the previous item is done with the lists
    load_graph(s, pos, mask, g, n);
    row_bits(s, n, cutoff, cap, cap_mode, i0, min(i0 + R1, n));
    team_sync();
    const int E = build_edges<false, R1>(s, n, cutoff, i0);
    const T* xg = x + (size_t)g * n * F + o0;
    float rows[FO / 64][4] = {};
    for (int e0 = first * ET; e0 < min(E, last * ET); e0 += ET) {
      const int ne = min(ET, E - e0);
      float2 xv[FO / 32][2];  // x_j
      gather_rows<FO, F>(xg, s.ej, e0, ne, xv);
      rbf_tile<C>(s, e0, ne, gs, cutoff, step, coeff);
      team_sync();
      {
        float acc[1][C::SC / 32][4];
        layer1<C>(s, b1, acc);
        store_h<C>(s, acc);
      }
      team_sync();
      float acc[1][FO / 32][4];
      layer2<C>(s, b2 + o0, acc);
      // message W_e gate_e x_j into the message tile; padding edges give 0
      const int r0 = ew_row0(), c0 = ew_col0<FO>();
#pragma unroll
      for (int nt = 0; nt < FO / 32; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
          const float gate = e < ne ? s.eg[e0 + e] : 0.f;
          *reinterpret_cast<float2*>(s.xs + e * C::SX + c) =
              make_float2(acc[0][nt][2 * half] * gate * xv[nt][half].x,
                          acc[0][nt][2 * half + 1] * gate * xv[nt][half].y);
        }
      team_sync();
      scatter_rows<FO, C::SX>(s.xs, s.ei, i0, e0, ne, rows);
    }
    store_rows<FO, F>(rows, out + (size_t)g * n * F + o0, i0, R1, n, first > 0 || last < tiles);
  }
}

// ------------------------------------------------------------ K2
// Block b computes slab b % NS of the input filters of h (all of them at
// F = 128); the blocks of a slab share out its tiles. dx is this slab's part
// (G, N, F) of dx, in f32: the slabs' parts start NS apart.
template <int F, int KG, class T>
__global__ void __launch_bounds__(THREADS, 1)
    cfconv_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                      const T* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const T* __restrict__ gout,
                      const int* __restrict__ item_tiles, float* __restrict__ dx,
                      float* __restrict__ partial, int G, int n, int gs, float cutoff, int cap,
                      int cap_mode) {
  using C = Cfg<F, KG, true>;
  constexpr int SC = C::SC;
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve<C, true>(smem);
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

  // this block's weight-gradient partials, summed over its items:
  // dW2[slab, :] (c x c'): warp w rows 32 (w % RG) .. +31, columns CW (w / RG) .. +CW-1;
  // dW1[:, slab]^T (c x k): warp w rows 16 (w % RG1) .. +15, columns KW (w / RG1) .. +KW-1.
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
      row_bits(s, n, cutoff, cap, cap_mode, 0, n);
      loaded = g;
    }
    __syncthreads();
    const int E = build_edges<true, R2>(s, n, cutoff, j0);
    const T* xg = x + (size_t)g * n * F;
    const T* gg = gout + (size_t)g * n * F;
    float rows[F / 64][4] = {};
    for (int e0 = first * ET; e0 < min(E, last * ET); e0 += ET) {
      const int ne = min(ET, E - e0);
      const int r0 = ew_row0(), c0 = ew_col0<F>();
      float2 gv[F / 32][2], xv[F / 32][2];  // g_i and x_j
      gather_rows<F, F>(gg, s.ei, e0, ne, gv);
      gather_rows<F, F>(xg, s.ej, e0, ne, xv);
      // F = 128: the gathers' latency hides behind P1; F = 256: their 64
      // registers are freed before it
      constexpr bool late_dw = F == 128;
      if constexpr (!late_dw) put_dw<C>(s, e0, ne, gv, xv);
      rbf_tile<C>(s, e0, ne, gs, cutoff, step, coeff);
      __syncthreads();
      float acc[1][SC / 32][4], sig[SC / 32][4];
      layer1<C>(s, b1 + c0s, acc);
#pragma unroll
      for (int nt = 0; nt < SC / 32; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sig[nt][r] = sigmoidf(acc[0][nt][r]);  // ssp'(pre)
      store_h<C>(s, acc);
      if constexpr (late_dw) put_dw<C>(s, e0, ne, gv, xv);
      __syncthreads();
      {
        // the dx message W_e gate_e g_i, this slab's part of W; padding
        // edges give 0
        float accw[1][F / 32][4];
        layer2<C>(s, slab == 0 ? b2 : nullptr, accw);
#pragma unroll
        for (int nt = 0; nt < F / 32; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
            float2* m = reinterpret_cast<float2*>(s.xs + e * C::SX + c);
            const float2 a = *m;
            *m = make_float2(accw[0][nt][2 * half] * a.x, accw[0][nt][2 * half + 1] * a.y);
          }
      }
      __syncthreads();
      scatter_rows<F, C::SX>(s.xs, s.ej, j0, e0, ne, rows);
      if (threadIdx.x < F)  // padding rows of the tile are zero
#pragma unroll
        for (int e = 0; e < ET; ++e) db2 += s.dwf[e * C::SD + threadIdx.x];
      // P3: dh = dW W2[slab, :]^T (edge x channel), then P4: dW2[slab, :] += h^T dW
      zero(acc);
      warp_mma<1, SC / 32, F>(acc, F32Tile<C::SD, 1>{s.dwf}, PackedWT<C::SW2>{s.w2}, r0,
                              ew_col0<SC>());
      warp_mma<2, CW / 8, ET>(dw2, F32Tile<1, C::SH>{s.h}, F32Tile<1, C::SD>{s.dwf},
                              32 * (warp % RG), CW * (warp / RG));
      __syncthreads();  // the dx sums are done with the message tile
      {
        const int cs = ew_col0<SC>();
#pragma unroll
        for (int nt = 0; nt < SC / 32; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = r0 + g8 + 8 * half, c = cs + nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(s.xs + e * C::SX + c) =
                make_float2(acc[0][nt][2 * half] * sig[nt][2 * half],
                            acc[0][nt][2 * half + 1] * sig[nt][2 * half + 1]);
          }
      }
      __syncthreads();
      // P5: dW1[:, slab]^T += dpre^T rbf
      warp_mma<1, KW / 8, ET>(dw1t, F32Tile<1, C::SX>{s.xs}, F32Tile<1, C::SR>{s.rbf},
                              16 * (warp % RG1), KW * (warp / RG1));
      if (db1_c >= 0)
#pragma unroll
        for (int e = 0; e < ET; ++e) db1 += s.xs[e * C::SX + db1_c];
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

// Sums the partial rows of the blocks of each slab in block order: one
// thread per gradient element. db2 comes from slab 0's blocks.
template <int F, int KG>
__global__ void cfconv_reduce_kernel(const float* __restrict__ partial, int blocks, int gs,
                                     float* __restrict__ dw1, float* __restrict__ db1,
                                     float* __restrict__ dw2, float* __restrict__ db2) {
  using C = Cfg<F, KG, true>;
  constexpr int SC = C::SC;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * F + gs * F + 2 * F) return;
  int slab = 0, at;  // the slab holding idx and its offset in the slab's row
  float* dst;
  if (idx < F * F) {
    const int c = idx / F;
    slab = c / SC, at = (c % SC) * F + idx % F, dst = dw2 + idx;
  } else if (idx < F * F + gs * F) {
    const int i = idx - F * F, c = i % F;
    slab = c / SC, at = SC * F + (i / F) * SC + c % SC, dst = dw1 + i;
  } else if (idx < F * F + gs * F + F) {
    const int c = idx - F * F - gs * F;
    slab = c / SC, at = SC * F + gs * SC + c % SC, dst = db1 + c;
  } else {
    const int c = idx - F * F - gs * F - F;
    at = SC * F + gs * SC + SC + c, dst = db2 + c;
  }
  const size_t row = C::partial_floats(gs);
  float acc = 0.f;
  for (int b = slab; b < blocks; b += C::NS) acc += partial[(size_t)b * row + at];
  *dst = acc;
}

// dst = the sum of the NS f32 parts, in part order, stored as T: K2's dx
// from its slabs' parts, and the bf16 and f16 variants' out and dx from
// their f32 scratch (NS = 1), rounded to nearest even.
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_elem(__half* p, float v) { *p = __float2half_rn(v); }

template <int NS, class T>
__global__ void cfconv_sum_parts_kernel(const float* __restrict__ parts, size_t count,
                                        T* __restrict__ dst) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  float acc = parts[idx];
#pragma unroll
  for (int s = 1; s < NS; ++s) acc += parts[s * count + idx];
  store_elem(dst + idx, acc);
}

// Raises a kernel's dynamic shared-memory limit, once per kernel and device.
template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  static const void* done[64][4] = {};  // per device, the kernels already raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void* key = reinterpret_cast<const void*>(kernel);
  if (dev < 64)
    for (const void* k : done[dev])
      if (k == key) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64)
    for (const void*& k : done[dev])
      if (k == nullptr) {
        k = key;
        break;
      }
  return (int)err;
}

template <int NS, class T>
int sum_parts(const float* parts, size_t count, T* dst, cudaStream_t st) {
  cfconv_sum_parts_kernel<NS, T><<<(unsigned)((count + 255) / 256), 256, 0, st>>>(parts, count, dst);
  return (int)cudaGetLastError();
}

template <int F, int KG, class T>
int fwd(const float* pos, const float* mask, const T* x, const float* w1, const float* b1,
        const float* w2, const float* b2, T* out, float* out32, int* item_tiles, int G, int N,
        int Gs, float cutoff, int cap, int cap_mode, int blocks, cudaStream_t st) {
  using C = Cfg<F, KG, false>;
  constexpr bool direct = std::is_same<T, float>::value;  // f32 sums straight into out
  float* acc = direct ? reinterpret_cast<float*>(out) : out32;
  const size_t count = (size_t)G * N * F;
  cudaError_t err;
  if ((err = cudaMemsetAsync(acc, 0, count * sizeof(float), st)) != cudaSuccess) return (int)err;
  cfconv_count_kernel<false><<<G, THREADS, 0, st>>>(pos, mask, N, cutoff, cap, cap_mode,
                                                    item_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int code = set_smem(cfconv_fwd_kernel<F, KG, T>, C::SMEM);
  if (code != 0) return code;
  cfconv_fwd_kernel<F, KG, T><<<blocks, C::TEAMS * THREADS, C::SMEM, st>>>(
      pos, mask, x, w1, b1, w2, b2, item_tiles, acc, G, N, Gs, cutoff, cap, cap_mode);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (!direct) return sum_parts<1, T>(acc, count, out, st);
  return 0;
}

template <int F, int KG, class T>
int bwd(const float* pos, const float* mask, const T* x, const float* w1, const float* b1,
        const float* w2, const float* b2, const T* gout, T* dx, float* dx_parts, float* dw1,
        float* db1, float* dw2, float* db2, float* partial, int* item_tiles, int G, int N, int Gs,
        float cutoff, int cap, int cap_mode, int blocks, cudaStream_t st) {
  using C = Cfg<F, KG, true>;
  constexpr bool direct = std::is_same<T, float>::value && C::NS == 1;  // dx written in place
  const size_t count = (size_t)G * N * F;
  float* parts = direct ? reinterpret_cast<float*>(dx) : dx_parts;
  cudaError_t err;
  if ((err = cudaMemsetAsync(parts, 0, C::NS * count * sizeof(float), st)) != cudaSuccess)
    return (int)err;
  cfconv_count_kernel<true><<<G, THREADS, 0, st>>>(pos, mask, N, cutoff, cap, cap_mode,
                                                   item_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int code = set_smem(cfconv_bwd_kernel<F, KG, T>, C::SMEM);
  if (code != 0) return code;
  cfconv_bwd_kernel<F, KG, T><<<blocks, THREADS, C::SMEM, st>>>(
      pos, mask, x, w1, b1, w2, b2, gout, item_tiles, parts, partial, G, N, Gs, cutoff, cap,
      cap_mode);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = F * F + Gs * F + 2 * F;
  cfconv_reduce_kernel<F, KG><<<(total + 255) / 256, 256, 0, st>>>(partial, blocks, Gs, dw1, db1,
                                                                   dw2, db2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (!direct) return sum_parts<C::NS, T>(parts, count, dx, st);
  return 0;
}

// The compiled widths: F = 128 with Gs <= 64, F = 256 with Gs <= 16.
bool compiled(int F, int Gs) {
  return Gs >= 2 && ((F == 128 && Gs <= 64) || (F == 256 && Gs <= 16));
}

// Node-feature types 0 (f32), 1 (bf16), 2 (f16); cap modes 0 (index), 1 (nearest).
bool valid_modes(int dtype, int cap_mode) {
  return dtype >= 0 && dtype <= 2 && (cap_mode == 0 || cap_mode == 1);
}

}  // namespace

#ifndef CFCONV_HELPERS_ONLY
extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Slabs of a width's blocks: its persistent grid is a multiple of this.
// K1 (bwd 0) splits the output filters, K2 (bwd 1) the filters of h; K2's
// dx parts scratch holds this many (G, N, F) parts when it is above 1.
int cfconv_slabs(int F, int bwd) {
  if (F == 128) return 1;
  if (F == 256) return bwd ? Cfg<256, 16, true>::NS : Cfg<256, 16, false>::NS;
  return 0;
}

// Floats of the (blocks, .) scratch that K2 needs per block.
int cfconv_partial_floats(int F, int gs) {
  if (F == 128) return Cfg<128, 64, true>::partial_floats(gs);
  if (F == 256) return Cfg<256, 16, true>::partial_floats(gs);
  return 0;
}

// K1. pos (G,N,3), mask (G,N) as 0/1 floats, x (G,N,F), w1 (Gs,F), b1 (F),
// w2 (F,F), b2 (F) -> out (G,N,F) of x's type: f32 (dtype 0), bf16 (1) or
// f16 (2); for the last two out32 is an f32 scratch of G*N*F floats
// (unused otherwise). The rest is f32; all contiguous, 16-byte aligned, on
// the device. cap_mode 0 keeps the first neighbours by index, 1 the nearest.
// `blocks` is the persistent grid size, a multiple of cfconv_slabs(F, 0),
// and item_tiles a scratch of G * ceil(N/4) ints.
int cfconv_fwd(const float* pos, const float* mask, const void* x, const float* w1,
               const float* b1, const float* w2, const float* b2, void* out, float* out32,
               int* item_tiles, int G, int N, int F, int Gs, float cutoff, int cap, int cap_mode,
               int blocks, int dtype, void* stream) {
  if (!compiled(F, Gs) || blocks % cfconv_slabs(F, 0) || !valid_modes(dtype, cap_mode))
    return (int)cudaErrorInvalidValue;
  const auto run = [&](auto tag) {
    using T = decltype(tag);
    const auto xt = static_cast<const T*>(x);
    const auto ot = static_cast<T*>(out);
    cudaStream_t st = (cudaStream_t)stream;
    if (F == 128)
      return fwd<128, 64, T>(pos, mask, xt, w1, b1, w2, b2, ot, out32, item_tiles, G, N, Gs,
                             cutoff, cap, cap_mode, blocks, st);
    return fwd<256, 16, T>(pos, mask, xt, w1, b1, w2, b2, ot, out32, item_tiles, G, N, Gs, cutoff,
                           cap, cap_mode, blocks, st);
  };
  if (dtype == 1) return run(__nv_bfloat16{});
  if (dtype == 2) return run(__half{});
  return run(0.f);
}

// K2. As K1 plus the cotangent gout (G,N,F) of x's type, a scratch of
// blocks * cfconv_partial_floats(F, Gs) floats, one of G * ceil(N/8) ints
// and, where cfconv_slabs(F, 1) > 1 or dtype is not 0, one of that many (at
// least one) f32 (G,N,F) dx parts (dx_parts; unused otherwise). `blocks`
// is a multiple of cfconv_slabs(F, 1). Writes dx (G,N,F) of x's type and
// the f32 weight gradients summed over all graphs.
int cfconv_bwd(const float* pos, const float* mask, const void* x, const float* w1,
               const float* b1, const float* w2, const float* b2, const void* gout, void* dx,
               float* dx_parts, float* dw1, float* db1, float* dw2, float* db2, float* partial,
               int* item_tiles, int G, int N, int F, int Gs, float cutoff, int cap, int cap_mode,
               int blocks, int dtype, void* stream) {
  if (!compiled(F, Gs) || blocks % cfconv_slabs(F, 1) || !valid_modes(dtype, cap_mode))
    return (int)cudaErrorInvalidValue;
  const auto run = [&](auto tag) {
    using T = decltype(tag);
    const auto xt = static_cast<const T*>(x);
    const auto gt = static_cast<const T*>(gout);
    const auto dt = static_cast<T*>(dx);
    cudaStream_t st = (cudaStream_t)stream;
    if (F == 128)
      return bwd<128, 64, T>(pos, mask, xt, w1, b1, w2, b2, gt, dt, dx_parts, dw1, db1, dw2, db2,
                             partial, item_tiles, G, N, Gs, cutoff, cap, cap_mode, blocks, st);
    return bwd<256, 16, T>(pos, mask, xt, w1, b1, w2, b2, gt, dt, dx_parts, dw1, db1, dw2, db2,
                           partial, item_tiles, G, N, Gs, cutoff, cap, cap_mode, blocks, st);
  };
  if (dtype == 1) return run(__nv_bfloat16{});
  if (dtype == 2) return run(__half{});
  return run(0.f);
}

}  // extern "C"
#endif  // CFCONV_HELPERS_ONLY
