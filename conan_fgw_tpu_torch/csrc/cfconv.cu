// Fused SchNet continuous-filter convolution (cfconv) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of conan_fgw_tpu/ops/pallas/cfconv.py:
//   K1 cfconv_fwd  <- _fused_fwd_impl / _kernel      (forward messages)
//   K2 cfconv_bwd  <- _fused_bwd_impl / _bwd_kernel  (dx and filter-MLP grads)
//
// Per conformer graph: Gram-form distances, the valid & radius & first-cap-
// by-index neighbour gate with cosine envelope, the Gaussian RBF, the filter
// MLP W = ssp(rbf W1 + b1) W2 + b2 and m_i = sum_j W_ij gate_ij x_j. No
// (G, N, N, F) tensor reaches device memory: the edge pipeline runs per tile
// of ET edges in shared memory and registers.
//
// What bounds it on this card: the filter MLP, 2 (Gs F + F F) flops per edge
// forward and 4 Gs F + 6 F F backward, over 99% of the work; the bytes (pos,
// x, the cotangent, the weights) are a few MB. So it is operation-bound, and
// the five products of the MLP are dense products of edge tiles with the
// (Gs, F) and (F, F) weights: tensor-core work. They run on the tensor cores
// with mma.sync.m16n8k16 in bf16, each f32 operand split in two (a = a_hi +
// a_lo + O(2^-17 a)) and the product taken as a_lo b_hi + a_hi b_lo +
// a_hi b_hi with f32 sums: about 16 bits, where one TF32 pass keeps 11 and
// does not hold the 5e-4 contract with any margin. The elementwise parts
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
//   Gs is zero-padded to KG = 64. W1 and W2 stay in shared memory for the
//   block's life, split to hi/lo once when they are staged; the edge tiles
//   are split as their fragments are loaded.
// - Row sums into out / dx: a sixth product on the tensor cores, the 0/1
//   selection of the item's rows times the message tile, accumulated over
//   the item's tiles in registers: fixed order, no branches.
// - Scheduling: a persistent grid of one block per SM. K1 runs two teams a
//   block (16 warps an SM) that share the weights; K2 needs more registers
//   and shared memory and runs one. A first small kernel counts each item's
//   tiles; each team then takes one contiguous run of nearly equal length of
//   the tile sequence, so an item may be computed in two parts, added into
//   the zeroed output (plan_tiles). The partition depends only on the data,
//   so every sum either kernel forms is the same on every run.
// - K2 weight gradients: each block keeps its dW2 / dW1 partials in MMA
//   accumulators (registers) and db1 / db2 in one register per channel,
//   writes them to a (P, .) scratch, and cfconv_reduce sums the P partials
//   in a fixed order. K1 and K2 are bit-identical run to run.
//
// Limits: F = 128 filters, 2 <= Gs <= 64 Gaussians, N <= 128 atoms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int F = 128;        // filters (the only width compiled)
constexpr int KG = 64;        // Gaussians, zero-padded to a multiple of 16
constexpr int ET = 32;        // edges per tile
constexpr int R1 = 4;         // rows per K1 work item
constexpr int R2 = 8;         // sources per K2 work item
constexpr int R = 8;          // the larger, for buffers
constexpr int MAXN = 128;     // atoms per graph
constexpr int NWORD = MAXN / 32;
constexpr int THREADS = 256;  // 8 warps
// Row strides (floats) of the shared tiles. A fragment reads element pairs
// (k, k+1): along a row as one 8-byte load at [g][2t] (conflict-free when
// stride % 32 is 8 or 24), or down a column as two loads at [2t][g] and
// [2t+1][g] (conflict-free when stride % 8 is 4). A tile read both ways
// takes the first; its column reads see 2-way conflicts.
constexpr int SR = 72;   // rbf  [e][k]: P1 A by row, P5 B by column
constexpr int SH = 136;  // h    [e][c]: P2 A by row, P4 A by column
constexpr int SD = 136;  // dWf  [e][c]: P3 A by row, P4 B by column
constexpr int SX = 132;  // msg / dx message / dpre [e][c]: row sums B and P5 A by column
constexpr float PI_F = 3.14159265358979323846f;
constexpr float LOG2_F = 0.69314718055994530942f;
static_assert(R1 <= R && R2 <= R && R <= THREADS / 32, "one warp per row / source of an item");
static_assert(ET == 32 && F == 128, "the warp tilings below cover a 32 x 128 edge tile");

// A team is THREADS threads (8 warps) that work on one item at a time with
// their own shared buffers and barrier; K2 runs one team a block, K1 two,
// which share the block's copy of the weights.
__device__ __forceinline__ int tid() { return threadIdx.x % THREADS; }
__device__ __forceinline__ int team() { return threadIdx.x / THREADS; }
__device__ __forceinline__ void team_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team()), "r"(THREADS) : "memory");
}

// The elementwise functions use the fast exp / log (absolute errors near
// 1e-7 on values of order 1, far inside the 5e-4 contract).
__device__ __forceinline__ float ssp(float x) {
  // softplus(x) - log 2, stable for large |x|
  return fmaxf(x, 0.f) + __logf(1.f + __expf(-fabsf(x))) - LOG2_F;
}

__device__ __forceinline__ float sigmoidf(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

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
// The split: x = hi + lo + O(2^-17 x), hi = bf16(x) and lo = bf16(x - hi),
// both rounded to nearest (ties away) on the bits, two elements packed per
// register (the lower k in the low half). x - hi is exact in f32. Integer
// adds, masks and byte permutes only: no conversion instruction.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0) + 0x8000u, u1 = __float_as_uint(x1) + 0x8000u;
  hi = __byte_perm(u0, u1, 0x7632);
  const float r0 = x0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(u1 & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(r0) + 0x8000u, __float_as_uint(r1) + 0x8000u, 0x7632);
}

// Elements p[0] and p[S] (consecutive k), split and packed.
template <int S>
__device__ __forceinline__ void load_split(const float* p, uint32_t& hi, uint32_t& lo) {
  if constexpr (S == 1) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    split_bf16x2(v.x, v.y, hi, lo);
  } else {
    split_bf16x2(p[0], p[S], hi, lo);
  }
}

// Operand loaders for warp_mma: load(r, k, hi, lo) gives the fragment
// register of elements (r, k) and (r, k+1) along the product's k, k even,
// split and packed; r is the row m of A or the column n of B.
// F32Tile: an f32 edge tile, element (r, k) at p[r*RS + k*KS], split as it
// is loaded (splitting a tile once where it is written measured slower).
template <int RS, int KS>
struct F32Tile {
  const float* p;
  __device__ __forceinline__ void load(int r, int k, uint32_t& hi, uint32_t& lo) const {
    load_split<KS>(p + r * RS + k * KS, hi, lo);
  }
};
// Weights split once when staged: p[(k/2)*SWP + n] holds the pair (k, k+1)
// of column n as {hi, lo}. PackedW reads B(k, n) = W(k, n) in one load;
// PackedWT reads B(k, n) = W(n, k) from the halves of two entries.
constexpr int SWP = 132;  // row stride in pairs: conflict-free 8-byte reads
struct PackedW {
  const uint2* p;
  __device__ __forceinline__ void load(int n, int k, uint32_t& hi, uint32_t& lo) const {
    const uint2 v = p[(k >> 1) * SWP + n];
    hi = v.x;
    lo = v.y;
  }
};
struct PackedWT {
  const uint2* p;
  __device__ __forceinline__ void load(int n, int k, uint32_t& hi, uint32_t& lo) const {
    const uint2 a = p[(n >> 1) * SWP + k], b = p[(n >> 1) * SWP + k + 1];
    const uint32_t sel = (n & 1) ? 0x7632u : 0x5410u;  // n's half of each pair
    hi = __byte_perm(a.x, b.x, sel);
    lo = __byte_perm(a.y, b.y, sel);
  }
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp adds A (rows m0 .. m0 + MT*16) times B (columns n0 .. n0 + NT*8)
// over k < K (a multiple of 16) to acc with the three-term bf16 split
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi. Accumulator layout (mma.sync):
// acc[mt][nt][r] is row m0 + mt*16 + g + 8*(r>>1), column n0 + nt*8 + 2t +
// (r&1), with g = lane/4, t = lane%4.
template <int MT, int NT, int K, class LA, class LB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const LA& A, const LB& B,
                                         int m0, int n0) {
  static_assert(K % 16 == 0, "mma.m16n8k16 steps");
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int k = k0 + 2 * t;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + mt * 16 + g;
      A.load(m, k, ah[mt][0], al[mt][0]);
      A.load(m + 8, k, ah[mt][1], al[mt][1]);
      A.load(m, k + 8, ah[mt][2], al[mt][2]);
      A.load(m + 8, k + 8, ah[mt][3], al[mt][3]);
    }
    if constexpr (MT * NT <= 4) {
      // few accumulators: the three passes one after another over all of
      // them, so that consecutive mma do not wait on each other's sums
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        B.load(n0 + nt * 8 + g, k, bh[nt][0], bl[nt][0]);
        B.load(n0 + nt * 8 + g, k + 8, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], ah[mt], bh[nt]);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        B.load(n0 + nt * 8 + g, k, bh[0], bl[0]);
        B.load(n0 + nt * 8 + g, k + 8, bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], al[mt], bh);
          mma_bf16(acc[mt][nt], ah[mt], bl);
          mma_bf16(acc[mt][nt], ah[mt], bh);
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
  uint2* w1;      // KG/2 x SWP, split pairs (PackedW)
  uint2* w2;      // F/2 x SWP
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

// Floats of shared memory: the weights, shared by the block's teams, then
// each team's own buffers.
constexpr int WEIGHT_FLOATS = KG * SWP + F * SWP;
__host__ __device__ constexpr int team_floats(bool bwd) {
  return ET * SR + ET * SH + (bwd ? ET * SD : 0) + ET * SX + 5 * MAXN + 4 * R * MAXN +
         MAXN * NWORD + 16;
}

// The calling thread's view: the shared weights and its team's buffers.
__device__ Smem carve(float* p, bool bwd) {
  Smem s;
  s.w1 = reinterpret_cast<uint2*>(p); p += KG * SWP;
  s.w2 = reinterpret_cast<uint2*>(p); p += F * SWP;
  p += team() * team_floats(bwd);
  s.rbf = p; p += ET * SR;
  s.h = p; p += ET * SH;
  s.dwf = p; if (bwd) p += ET * SD;
  s.xs = p; p += ET * SX;
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

// Stages W (rows x F, rows >= valid are zero) split into pairs along its
// rows: dst[(k/2)*SWP + n] = {hi, lo} of W(k, n), W(k+1, n). Done once per
// block; the split is the one fragment loads of f32 tiles make.
__device__ void stage_weights(uint2* dst, const float* w, int rows, int valid) {
  for (int idx = threadIdx.x; idx < rows / 2 * F; idx += blockDim.x) {
    const int k = 2 * (idx / F), n = idx % F;
    const float a = k < valid ? __ldg(w + k * F + n) : 0.f;
    const float b = k + 1 < valid ? __ldg(w + (k + 1) * F + n) : 0.f;
    uint2 v;
    split_bf16x2(a, b, v.x, v.y);
    dst[(k / 2) * SWP + n] = v;
  }
}

__device__ void load_weights(const Smem& s, const float* w1, const float* w2, int gs) {
  stage_weights(s.w1, w1, KG, gs);
  stage_weights(s.w2, w2, F, F);
}

__device__ void load_graph(const Smem& s, const float* pos, const float* mask, int g, int n) {
  for (int a = tid(); a < 3 * n; a += THREADS) s.pos[a] = pos[(size_t)g * n * 3 + a];
  for (int a = tid(); a < n; a += THREADS) s.mask[a] = mask[(size_t)g * n + a];
  team_sync();
  for (int a = tid(); a < n; a += THREADS) s.sq[a] = sqnorm(s.pos + 3 * a);
  team_sync();
}

// Neighbour bits of rows [r0, r1), one warp per row: torch-cluster's radius
// graph with the first-(cap+1)-candidates-by-index rule (self included as a
// candidate, then dropped). The rank of candidate j is a popcount prefix of
// the row's candidate ballots.
__device__ void row_bits(const Smem& s, int n, float cutoff, int cap, int r0, int r1) {
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
__device__ void rbf_tile(const Smem& s, int e0, int ne, int gs, float step, float coeff) {
  for (int idx = tid(); idx < ET * KG; idx += THREADS) {
    const int e = idx / KG, k = idx % KG;
    float v = 0.f;
    if (e < ne && k < gs) {
      const float diff = s.ed[e0 + e] - k * step;
      v = __expf(coeff * diff * diff);
    }
    s.rbf[e * SR + k] = v;
  }
}

// Warp tiling of the (ET x F) edge-by-channel products P1, P2, P3: warp w
// takes edge rows 16 (w % 2) .. +15 and channels 32 (w / 2) .. +31.
constexpr int EW_NT = 4;
__device__ __forceinline__ int ew_row0() { return 16 * ((tid() >> 5) & 1); }
__device__ __forceinline__ int ew_col0() { return 32 * (tid() >> 6); }

// P1: pre = rbf W1 + b1 into acc (bias added).
__device__ __forceinline__ void layer1(const Smem& s, const float* b1, float (&acc)[1][EW_NT][4]) {
  const int r0 = ew_row0(), c0 = ew_col0(), t = tid() & 3;
  zero(acc);
  warp_mma<1, EW_NT, KG>(acc, F32Tile<SR, 1>{s.rbf}, PackedW{s.w1}, r0, c0);
#pragma unroll
  for (int nt = 0; nt < EW_NT; ++nt) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c0 + nt * 8 + 2 * t));
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[0][nt][r] += (r & 1) ? bb.y : bb.x;
  }
}

// h = ssp(pre) into the h tile.
__device__ __forceinline__ void store_h(const Smem& s, const float (&acc)[1][EW_NT][4]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const int r0 = ew_row0(), c0 = ew_col0();
#pragma unroll
  for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = r0 + g + 8 * half, c = c0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(s.h + e * SH + c) =
          make_float2(ssp(acc[0][nt][2 * half]), ssp(acc[0][nt][2 * half + 1]));
    }
}

// Rows key[e] of a graph's (N, F) tensor at this thread's fragment positions
// of the edge tile (edge e, channels c, c+1); 0 for padding edges. Issued a
// phase before the values are used, so the loads' latency hides behind a
// product.
__device__ __forceinline__ void gather_rows(const float* base, const int* key, int e0, int ne,
                                            float2 (&v)[EW_NT][2]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const int r0 = ew_row0(), c0 = ew_col0();
#pragma unroll
  for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = r0 + g + 8 * half, c = c0 + nt * 8 + 2 * t;
      v[nt][half] = e < ne ? __ldg(reinterpret_cast<const float2*>(base + (size_t)key[e0 + e] * F + c))
                           : make_float2(0.f, 0.f);
    }
}

// P2: W = h W2 + b2 into acc (bias added).
__device__ __forceinline__ void layer2(const Smem& s, const float* b2, float (&acc)[1][EW_NT][4]) {
  const int r0 = ew_row0(), c0 = ew_col0(), t = tid() & 3;
  zero(acc);
  warp_mma<1, EW_NT, F>(acc, F32Tile<SH, 1>{s.h}, PackedW{s.w2}, r0, c0);
#pragma unroll
  for (int nt = 0; nt < EW_NT; ++nt) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c0 + nt * 8 + 2 * t));
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[0][nt][r] += (r & 1) ? bb.y : bb.x;
  }
}

// Row sums of the item on the tensor cores: rows[r][c] += sum_e S[r][e]
// tile[e][c] over the tile's edges, with the selection S[r][e] = 1 where
// edge e's key (target i for K1, source j for K2) is key0 + r, r < R. S is
// exact in bf16, so two passes (tile hi and lo) suffice. Warp w owns
// channels 16 w .. +15; acc rows g (r = 0, 1) are the item's rows, rows
// g + 8 stay zero. Fixed order, no atomics.
__device__ __forceinline__ void scatter_rows(const Smem& s, const int* key, int key0, int e0,
                                             int ne, float (&rows)[2][4]) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  const float* tile = s.xs + 16 * (tid() >> 5);
  constexpr uint32_t ONE = 0x3f80u;  // bf16 1.0
#pragma unroll
  for (int k0 = 0; k0 < ET; k0 += 16) {
    uint32_t a[4] = {0u, 0u, 0u, 0u};  // rows g + 8 (a[1], a[3]) select nothing
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = k0 + 2 * t + 8 * half;
      const uint32_t s0 = e < ne && key[e0 + e] - key0 == g ? ONE : 0u;
      const uint32_t s1 = e + 1 < ne && key[e0 + e + 1] - key0 == g ? ONE : 0u;
      a[2 * half] = s0 | (s1 << 16);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* b = tile + (k0 + 2 * t) * SX + nt * 8 + g;
      uint32_t bh[2], bl[2];
      load_split<SX>(b, bh[0], bl[0]);
      load_split<SX>(b + 8 * SX, bh[1], bl[1]);
      mma_bf16(rows[nt], a, bl);
      mma_bf16(rows[nt], a, bh);
    }
  }
}

// Writes the item's rows key0 .. key0+nr-1 (those below n) of dst (N, F),
// or adds them to dst when the item is computed in two parts.
__device__ __forceinline__ void store_rows(const float (&rows)[2][4], float* dst, int key0, int nr,
                                           int n, bool part) {
  const int lane = tid() & 31, g = lane >> 2, t = lane & 3;
  if (g >= nr || key0 + g >= n) return;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float* p = dst + (size_t)(key0 + g) * F + 16 * (tid() >> 5) + nt * 8 + 2 * t;
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
// kernels form is the same from run to run.
template <bool SOURCE_MAJOR>
__global__ void __launch_bounds__(THREADS)
    cfconv_count_kernel(const float* __restrict__ pos, const float* __restrict__ mask, int n,
                        float cutoff, int cap, int* __restrict__ item_tiles) {
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
  row_bits(s, n, cutoff, cap, 0, n);
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
__global__ void __launch_bounds__(2 * THREADS, 1)
    cfconv_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                      const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const int* __restrict__ item_tiles,
                      float* __restrict__ out, int G, int n, int gs, float cutoff, int cap) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, false);
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const int per_graph = (n + R1 - 1) / R1;
  load_weights(s, w1, w2, gs);
  __syncthreads();
  const TileRun run =
      plan_tiles(s.cnt, item_tiles, G * per_graph, 2 * gridDim.x, 2 * blockIdx.x + team());

  for (int item = run.k_lo, off = run.off_lo; item < run.k_hi; ++item) {
    const int g = item / per_graph, i0 = (item % per_graph) * R1;
    const int tiles = item_tiles[item];
    const int first = max(run.t_lo - off, 0), last = min(run.t_hi - off, tiles);  // its part
    off += tiles;
    if (first >= last) continue;  // a row block without edges: its rows stay zero
    team_sync();  // the previous item is done with the lists
    load_graph(s, pos, mask, g, n);
    row_bits(s, n, cutoff, cap, i0, min(i0 + R1, n));
    team_sync();
    const int E = build_edges<false, R1>(s, n, cutoff, i0);
    const float* xg = x + (size_t)g * n * F;
    float rows[2][4] = {};
    for (int e0 = first * ET; e0 < min(E, last * ET); e0 += ET) {
      const int ne = min(ET, E - e0);
      float2 xv[EW_NT][2];  // x_j
      gather_rows(xg, s.ej, e0, ne, xv);
      rbf_tile(s, e0, ne, gs, step, coeff);
      team_sync();
      float acc[1][EW_NT][4];
      layer1(s, b1, acc);
      store_h(s, acc);
      team_sync();
      layer2(s, b2, acc);
      // message W_e gate_e x_j into the message tile; padding edges give 0
      const int r0 = ew_row0(), c0 = ew_col0();
#pragma unroll
      for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
          const float gate = e < ne ? s.eg[e0 + e] : 0.f;
          *reinterpret_cast<float2*>(s.xs + e * SX + c) =
              make_float2(acc[0][nt][2 * half] * gate * xv[nt][half].x,
                          acc[0][nt][2 * half + 1] * gate * xv[nt][half].y);
        }
      team_sync();
      scatter_rows(s, s.ei, i0, e0, ne, rows);
    }
    store_rows(rows, out + (size_t)g * n * F, i0, R1, n, first > 0 || last < tiles);
  }
}

// ------------------------------------------------------------ K2
// Partial sums of one block in the scratch row: dW2 (F x F), dW1 (gs x F),
// db1 (F), db2 (F).
__host__ __device__ constexpr int partial_floats(int gs) { return F * F + gs * F + 2 * F; }

__global__ void __launch_bounds__(THREADS, 1)
    cfconv_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                      const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ gout,
                      const int* __restrict__ item_tiles, float* __restrict__ dx,
                      float* __restrict__ partial, int G, int n, int gs, float cutoff, int cap) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const int per_graph = (n + R2 - 1) / R2;
  load_weights(s, w1, w2, gs);
  const TileRun run = plan_tiles(s.cnt, item_tiles, G * per_graph, gridDim.x, blockIdx.x);  // orders the weights too

  // this block's weight-gradient partials, summed over its items:
  // dW2 (c x c'): warp w rows 32 (w % 4) .. +31, columns 64 (w / 4) .. +63;
  // dW1^T (c x k): warp w rows 16 w .. +15, all KG columns.
  float dw2[2][8][4], dw1t[1][KG / 8][4];
  zero(dw2);
  zero(dw1t);
  float db = 0.f;  // db2 for threads < F, db1 for threads >= THREADS - F (channel c)
  const int db_c = threadIdx.x < F ? threadIdx.x : threadIdx.x - (THREADS - F);

  for (int item = run.k_lo, off = run.off_lo, loaded = -1; item < run.k_hi; ++item) {
    const int g = item / per_graph, j0 = (item % per_graph) * R2;
    const int tiles = item_tiles[item];
    const int first = max(run.t_lo - off, 0), last = min(run.t_hi - off, tiles);  // its part
    off += tiles;
    if (first >= last) continue;  // an item without edges: its dx rows stay zero
    __syncthreads();
    if (g != loaded) {  // consecutive items of a graph share its neighbour bits
      load_graph(s, pos, mask, g, n);
      row_bits(s, n, cutoff, cap, 0, n);
      loaded = g;
    }
    __syncthreads();
    const int E = build_edges<true, R2>(s, n, cutoff, j0);
    const float* xg = x + (size_t)g * n * F;
    const float* gg = gout + (size_t)g * n * F;
    float rows[2][4] = {};
    for (int e0 = first * ET; e0 < min(E, last * ET); e0 += ET) {
      const int ne = min(ET, E - e0);
      float2 gv[EW_NT][2], xv[EW_NT][2];  // g_i and x_j
      gather_rows(gg, s.ei, e0, ne, gv);
      gather_rows(xg, s.ej, e0, ne, xv);
      rbf_tile(s, e0, ne, gs, step, coeff);
      __syncthreads();
      float acc[1][EW_NT][4], sig[EW_NT][4];
      layer1(s, b1, acc);
#pragma unroll
      for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sig[nt][r] = sigmoidf(acc[0][nt][r]);  // ssp'(pre)
      store_h(s, acc);
      // dW_e = gate_e g_i x_j, the filter's cotangent; gate_e g_i waits in
      // the message tile for the dx message (this thread's own slots)
      const int r0 = ew_row0(), c0 = ew_col0();
#pragma unroll
      for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
          const float gate = e < ne ? s.eg[e0 + e] : 0.f;
          const float2 a = make_float2(gate * gv[nt][half].x, gate * gv[nt][half].y), b = xv[nt][half];
          *reinterpret_cast<float2*>(s.dwf + e * SD + c) = make_float2(a.x * b.x, a.y * b.y);
          *reinterpret_cast<float2*>(s.xs + e * SX + c) = a;
        }
      __syncthreads();
      layer2(s, b2, acc);
      // the dx message W_e gate_e g_i; padding edges give 0
#pragma unroll
      for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
          float2* m = reinterpret_cast<float2*>(s.xs + e * SX + c);
          const float2 a = *m;
          *m = make_float2(acc[0][nt][2 * half] * a.x, acc[0][nt][2 * half + 1] * a.y);
        }
      __syncthreads();
      scatter_rows(s, s.ej, j0, e0, ne, rows);
      if (threadIdx.x < F)  // padding rows of the tile are zero
#pragma unroll
        for (int e = 0; e < ET; ++e) db += s.dwf[e * SD + db_c];
      // P3: dh = dW W2^T (edge x channel), then P4: dW2 += h^T dW
      zero(acc);
      warp_mma<1, EW_NT, F>(acc, F32Tile<SD, 1>{s.dwf}, PackedWT{s.w2}, r0, c0);
      warp_mma<2, 8, ET>(dw2, F32Tile<1, SH>{s.h}, F32Tile<1, SD>{s.dwf}, 32 * (warp & 3),
                         64 * (warp >> 2));
      __syncthreads();  // the dx sums are done with the message tile
#pragma unroll
      for (int nt = 0; nt < EW_NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = r0 + g8 + 8 * half, c = c0 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(s.xs + e * SX + c) =
              make_float2(acc[0][nt][2 * half] * sig[nt][2 * half],
                          acc[0][nt][2 * half + 1] * sig[nt][2 * half + 1]);
        }
      __syncthreads();
      // P5: dW1^T += dpre^T rbf
      warp_mma<1, KG / 8, ET>(dw1t, F32Tile<1, SX>{s.xs}, F32Tile<1, SR>{s.rbf}, 16 * warp, 0);
      if (threadIdx.x >= THREADS - F)
#pragma unroll
        for (int e = 0; e < ET; ++e) db += s.xs[e * SX + db_c];
      __syncthreads();  // rbf and the dpre tile are rewritten by the next tile
    }
    store_rows(rows, dx + (size_t)g * n * F, j0, R2, n, first > 0 || last < tiles);
  }

  float* p = partial + (size_t)blockIdx.x * partial_floats(gs);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 32 * (warp & 3) + 16 * mt + g8 + 8 * (r >> 1);
        const int c2 = 64 * (warp >> 2) + 8 * nt + 2 * t + (r & 1);
        p[c * F + c2] = dw2[mt][nt][r];
      }
#pragma unroll
  for (int nt = 0; nt < KG / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 16 * warp + g8 + 8 * (r >> 1), k = 8 * nt + 2 * t + (r & 1);
      if (k < gs) p[F * F + k * F + c] = dw1t[0][nt][r];
    }
  if (threadIdx.x < F) p[F * F + gs * F + F + db_c] = db;               // db2
  else if (threadIdx.x >= THREADS - F) p[F * F + gs * F + db_c] = db;  // db1
}

// Sums the P partial rows in block order: one thread per gradient element.
__global__ void cfconv_reduce_kernel(const float* __restrict__ partial, int blocks, int gs,
                                     float* __restrict__ dw1, float* __restrict__ db1,
                                     float* __restrict__ dw2, float* __restrict__ db2) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = partial_floats(gs);
  if (idx >= total) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * total + idx];
  if (idx < F * F) dw2[idx] = acc;
  else if (idx < F * F + gs * F) dw1[idx - F * F] = acc;
  else if (idx < F * F + gs * F + F) db1[idx - F * F - gs * F] = acc;
  else db2[idx - F * F - gs * F - F] = acc;
}

// Raises a kernel's dynamic shared-memory limit, once per device.
template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Floats of the (blocks, .) scratch that K2 needs per block.
int cfconv_partial_floats(int gs) { return partial_floats(gs); }

// K1. pos (G,N,3), mask (G,N) as 0/1 floats, x (G,N,128), w1 (Gs,128),
// b1 (128), w2 (128,128), b2 (128) -> out (G,N,128). All f32, contiguous,
// 16-byte aligned, on the device. `blocks` is the persistent grid size and
// item_tiles a scratch of G * ceil(N/4) ints.
int cfconv_fwd(const float* pos, const float* mask, const float* x, const float* w1,
               const float* b1, const float* w2, const float* b2, float* out, int* item_tiles,
               int G, int N, int Gs, float cutoff, int cap, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaMemsetAsync(out, 0, (size_t)G * N * F * sizeof(float), st)) != cudaSuccess)
    return (int)err;
  cfconv_count_kernel<false><<<G, THREADS, 0, st>>>(pos, mask, N, cutoff, cap, item_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(WEIGHT_FLOATS + 2 * team_floats(false)) * sizeof(float);
  int code = set_smem(cfconv_fwd_kernel, smem);
  if (code != 0) return code;
  cfconv_fwd_kernel<<<blocks, 2 * THREADS, smem, st>>>(pos, mask, x, w1, b1, w2, b2, item_tiles,
                                                       out, G, N, Gs, cutoff, cap);
  return (int)cudaGetLastError();
}

// K2. As K1 plus the cotangent gout (G,N,128), a scratch of
// blocks * cfconv_partial_floats(Gs) floats and one of G * ceil(N/8) ints. Writes dx (G,N,128) and the
// weight gradients summed over all graphs.
int cfconv_bwd(const float* pos, const float* mask, const float* x, const float* w1,
               const float* b1, const float* w2, const float* b2, const float* gout, float* dx,
               float* dw1, float* db1, float* dw2, float* db2, float* partial, int* item_tiles,
               int G, int N, int Gs, float cutoff, int cap, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaMemsetAsync(dx, 0, (size_t)G * N * F * sizeof(float), st)) != cudaSuccess)
    return (int)err;
  cfconv_count_kernel<true><<<G, THREADS, 0, st>>>(pos, mask, N, cutoff, cap, item_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(WEIGHT_FLOATS + team_floats(true)) * sizeof(float);
  int code = set_smem(cfconv_bwd_kernel, smem);
  if (code != 0) return code;
  cfconv_bwd_kernel<<<blocks, THREADS, smem, st>>>(pos, mask, x, w1, b1, w2, b2, gout,
                                                   item_tiles, dx, partial, G, N, Gs, cutoff, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = partial_floats(Gs);
  cfconv_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, blocks, Gs, dw1, db1, dw2,
                                                            db2);
  return (int)cudaGetLastError();
}

}  // extern "C"
