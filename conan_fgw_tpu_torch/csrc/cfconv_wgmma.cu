// The cfconv kernels K1 and K2 for graphs above 128 atoms, on Hopper's
// warpgroup products (sm_90a).
//
// Replaces the Pallas TPU kernels of conan_fgw_tpu/ops/pallas/cfconv.py
// above the 128 atoms that csrc/cfconv.cu's kernels hold:
//   K1 <- :214 _fused_fwd_impl (its _kernel): the messages
//        m_i = sum_j W(d_ij) gate_ij x_j, W = ssp(rbf W1 + b1) W2 + b2;
//   K2 <- :136 _fused_bwd_impl (its _bwd_kernel): dx and the filter MLP's
//        weight gradients.
// The arithmetic is cfconv.cu's: the capped radius graph, the Gaussian RBF,
// the filter MLP's five products in 3xTF32 (a b ~ a_small b_big + a_big
// b_small + a_big b_big, f32 sums), the elementwise parts in f32 on the
// CUDA cores (softplus and sigmoid on the special-function unit, below).
//
// What bounds them on this card: the filter MLP, 2 (Gs F + F F) flops an
// edge forward and 4 Gs F + 6 F F backward, is over 99% of the work and the
// bytes are a few MB, so they are operation-bound, by the tensor cores; the
// elementwise work of an edge (F softplus forward, F softplus and sigmoid
// backward) runs beside the products and, with few warps an SM, takes as
// long as they do. The kernels they replace (cfconv_large.cu: cfconv.cu's
// pipeline with the graph's state sized at run time) reached 4.4-7.1% of
// the bound:
// one team of 8 warps a block ran 3xTF32 mma.sync, latency-bound, every
// fragment split as it was loaded, weights included; no stage of a tile
// overlapped another; every item rebuilt its graph's neighbour bits; at
// F = 256 every slab rebuilt the edge list, and K2's slabs wrote four
// (G, N, F) parts of dx that a third kernel summed.
//
// The design:
// - Edge lists once a call: cfconv_edge_count_kernel builds a graph's
//   neighbour bits (index or nearest cap) and each work item's edge count,
//   cfconv_edge_write_kernel compacts each item's edges into whole tiles of
//   WET = 64 edge records {key, other, distance, gate} in device memory,
//   its last tile padded with records of gate 0 and key PAD_KEY. An item is
//   KEYS = 4 consecutive keys of a graph: K1's target rows i (edges by
//   graph, i, j) or, for K2, source atoms j (by graph, j, i). Every kernel
//   after them streams whole tiles.
// - All five products on wgmma.mma_async in TF32, 64 edges a warpgroup.
//   The weights sit in shared memory, split into big and small parts once
//   as a block stages them, each stored already rounded (cvt.rna.tf32.f32
//   on the bits, as ops/cuda/cfconv.py's split_mm rounds): wgmma reads only
//   a word's TF32 bits. Operands are K-major, as .tf32 requires, in 8-row
//   by 16-byte core matrices without a swizzle. A product that reduces over
//   channels takes the tile's operand (the RBF, h, the filter's cotangent
//   dW) from registers, split in the accumulator's own layout: within each
//   k-step the weights' k is permuted (2t and 2t + 1 to rows t and t + 4),
//   so a thread's accumulator pair (columns 2t, 2t + 1) is its A fragment
//   (columns t, t + 4), and layer 1's accumulator feeds layer 2 with no
//   trip through shared memory (each fragment built in four consecutive
//   registers, as wgmma reads them). K2's P4 (dW2 += h^T dW) and P5 (dW1 +=
//   rbf^T dpre) reduce over the edges: their operands go to shared memory
//   edge-contiguous and split (h^T, then dpre^T in its place, dW^T,
//   rbf^T).
// - K1 and K2's dx are one kernel (cfconv_msg_wgmma_kernel): dx_j = sum_i
//   W(d_ij) gate_ij g_i is K1 over the source-major list with the
//   cotangent g in place of x. Two warpgroups a block, each
//   on its own run of whole items (every output row written once, no
//   atomics), the other's products running while one gathers or sums;
//   each keeps a two-stage cp.async ring of edge records, the next tile's
//   loading while this one computes, and gathers the x_j (g_i) rows of its
//   tile into registers ahead of the row sums that use them. Barriers are
//   per warpgroup (bar.sync on a named barrier of 128 threads). F = 128 in
//   one slab (W1 and W2 split: 192 KB); F = 256 in four slabs of 64 output
//   filters, each block holding all of W1 and its columns of W2 (160 KB).
//   Layer 1 and layer 2 run in passes of 64 channels of h, layer 2 into
//   one accumulator of the slab's filters; each accumulator chain starts
//   with scale-d 0 rather than from zeroed registers. The row sums run on
//   the CUDA cores: the message (W + b2) gate x goes to shared memory 32
//   columns at a time and warp r sums, lane by column, the tile's edges of
//   key r (a run: the tile is sorted by key) in edge order.
// - K2's weight gradients (cfconv_dw_wgmma_kernel): one warpgroup a block
//   on 64 channels of h by 64 filters (a block type), the blocks of a type
//   splitting the tiles evenly. Per tile: dW from the gathered rows to
//   dW^T and P3 (dh = dW W2^T) from registers; P1, the RBF to rbf^T, h to
//   h^T and dpre = dh ssp'(pre); P4 from h^T and dW^T; dpre to dpre^T; P5
//   from dpre^T and rbf^T; db1 and db2 from the same tiles.
//   Each tile's P4 and P5 go to accumulators of their own, added to the
//   block's partials on the CUDA cores: a sum of hundreds of tiles keeps
//   the tensor cores' accumulation error of one tile, not of thousands of
//   k-steps (the kernel they replace lay 1e-4 from the plain version in
//   dW1 and dW2 at F = 256, these 2e-6). The partials live in registers
//   (dW2's block 32 a thread, dW1's 32 or 8; the kernel they replace held
//   its partials in 238-255), and cfconv_dw_reduce_kernel sums them
//   in a fixed order (dpre is linear in dh, so each filter block's part of
//   dW1 and db1 is summed there too). Two blocks share an SM and the
//   threads gather their rows.
// - K2 at F = 128 is not on this route: csrc/cfconv_large.cu's mma.sync
//   kernel (one pass of layer 1 a tile for dx and the weight gradients
//   together) took 1.38-2.32 ms at N = 160-256 on G = 90 graphs where this
//   route's two kernels took 2.08-3.36 (each recomputes layer 1 and the
//   softplus of every edge, and the F = 128 gradient kernel, with KG = 64,
//   held one warpgroup an SM). The wrapper picks that kernel by F.
// - Why no thread-block cluster at F = 256: each slab recomputes layer 1
//   and the softplus of all 256 channels of h (the softplus is 41% of the
//   message kernel there). A cluster of the four slabs, CTA r computing
//   channels 64 r .. alone and layer 2 reading the other three passes' h
//   from its peers' shared memory (48 KB a tile a warpgroup, ordered by
//   two mbarriers a warpgroup), was built and measured: 15.3-17.6 thousand
//   cycles a tile for layer 1, the exchange and layer 2, against 11.7
//   thousand for recomputing (K1 at N = 192, G = 90: 1.83-2.10 ms against
//   1.48). The exchange costs more than the softplus it saves.
// - Bit for bit, run to run: every partition (items and tiles to blocks,
//   the partials' order) depends only on the data; no atomics. Node
//   features f32, bf16 or f16 (a run-time dtype): widened as they are
//   loaded, the rest the f32 arithmetic, out and dx summed in f32 and
//   rounded once (cfconv_sum_parts_kernel), so a bf16 or f16 call gives the
//   f32 kernels' result on the widened inputs, rounded. The neighbour cap
//   (index or nearest) is a run-time argument of the edge kernels.
//
// Limits: K1 at F = 128 with 2 <= Gs <= 64 and at F = 256 with 2 <= Gs <=
// 16, K2 at F = 256; any N. cfconv_wgmma_plan sizes a call's buffers. The
// wgmma fences, descriptors and 3xTF32 issue helpers live in
// csrc/wgmma_tf32.cuh, shared with csrc/fgw_team.cu.

#define CFCONV_HELPERS_ONLY
#include "cfconv.cu"

#include <algorithm>

namespace {

constexpr int WET = 64;                 // edges a tile: one wgmma M
constexpr int KEYS = 4;                 // keys (rows of the output) a work item
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int TEAMS2 = 2;               // warpgroups a block
constexpr int PAD_KEY = 0x7fffffff;     // the key of a padding record
static_assert(KEYS == WG / 32, "warp r of a warpgroup sums key r of an item");

__host__ __device__ constexpr int words_of(int n) { return (n + 31) / 32; }

// ------------------------------------------------------------ warpgroups
__device__ __forceinline__ int wg() { return threadIdx.x / WG; }
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg()), "r"(WG) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

#include "wgmma_tf32.cuh"

// ------------------------------------------------------------ elementwise
// h = softplus(x) - log 2 and ssp'(x) = sigmoid(x), from one t = exp(-|x|)
// on the special-function unit: h = max(x, 0) + (log2(1 + t) - 1) ln 2,
// sigmoid(x) = 1 / (1 + t) or t / (1 + t), the reciprocal to 1 ulp.
// ex2.approx errs by 2^-22 of its result, lg2.approx by 2^-22 in
// absolute terms on [1, 2], and 1 + t rounds by 2^-24: h errs by at most
// 3.4e-7 in absolute terms (near x = 0; ops/cuda/cfconv.py::ssp_approx
// restates the formula and tests/test_torch_cfconv_wgmma.py bounds it with
// these errors at their limits), about twice cfconv.cu's log1pf / expf
// route (whose result is absolute-limited too, near x = 0, by the
// subtraction of log 2), at a quarter of its instructions; F of them an
// edge and width were half of these kernels' issue slots with the accurate
// route. This departs from the accurate route that csrc/cfconv.cu keeps
// (and the kernels above 128 atoms kept before): the attention head's
// N = 64 step lost its gate with fast intrinsics there, which took the
// RBF's exponent too. The RBF keeps the accurate expf: its exponent
// reaches 50 and more, where ex2.approx's argument rounding shows.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E_F = 1.44269504088896340736f;

// 1 / x to 1 ulp (rcp.approx.ftz: x = 1 + t lies in [1, 2] here).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ssp_t(float x, float t) {
  return fmaxf(x, 0.f) + (lg2_approx(1.f + t) - 1.f) * LOG2_F;
}
__device__ __forceinline__ float exp_neg_abs(float x) { return ex2_approx(-fabsf(x) * LOG2E_F); }
__device__ __forceinline__ float ssp_fast(float x) { return ssp_t(x, exp_neg_abs(x)); }

// fn(std::integral_constant<int, I>) for I = B .. E - 1: a loop whose index
// is a constant expression in its body.
template <int B, int E, class Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (B < E) {
    fn(std::integral_constant<int, B>{});
    static_for<B + 1, E>(fn);
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Stages B(k, n) = src[k sk + n sn] (0 where k >= valid) for k < K, n < NR
// as its big and small TF32 parts in the bofs layout, k permuted. Run once by
// the whole block; reads run along the source's contiguous index.
__device__ void stage_b(uint32_t* big, uint32_t* small, const float* __restrict__ src, int sk,
                        int sn, int K, int valid, int NR) {
  for (int idx = threadIdx.x; idx < K * NR; idx += blockDim.x) {
    const int n = sn == 1 ? idx % NR : idx / K, k = sn == 1 ? idx / NR : idx % K;
    const float v = k < valid ? __ldg(src + (size_t)k * sk + (size_t)n * sn) : 0.f;
    uint32_t b, s;
    split_tf32(v, b, s);
    const int o = bofs(n, kperm(k), K);
    big[o] = b;
    small[o] = s;
  }
}

// Node features of type dtype (0 f32, 1 bf16, 2 f16), widened: the pair
// i, i + 1 (i even).
__device__ __forceinline__ float2 load_feat2(const void* p, size_t i, int dtype) {
  if (dtype == 1) return load_feature_pair(static_cast<const __nv_bfloat16*>(p) + i);
  if (dtype == 2) return load_feature_pair(static_cast<const __half*>(p) + i);
  return load_feature_pair(static_cast<const float*>(p) + i);
}

// Layer 1's A fragments: the RBF of edges e1 (distance d1) and e2 (d2) at
// Gaussians k = 8 s + 2 t (+ 1), split; 0 for k >= gs. The centres and the
// order of operations are rbf_tile's (torch.linspace, gaussian_smearing).
// With tile, also the raw values at [e][k] (row stride SR).
template <int KG, int SR>
__device__ __forceinline__ void rbf_frag(uint32_t (&rb)[KG / 8][4], uint32_t (&rs)[KG / 8][4],
                                         float d1, float d2, int e1, int e2, int gs, float cutoff,
                                         float step, float coeff, float* tile) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < KG / 8; ++s) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 8 * s + 2 * t + (q >> 1);
      v[q] = 0.f;
      if (k < gs) {
        const float mu = k < gs / 2 ? step * k : cutoff - step * (gs - 1 - k);
        const float diff = ((q & 1) ? d2 : d1) - mu;
        v[q] = expf(coeff * (diff * diff));
      }
      split_tf32(v[q], rb[s][q], rs[s][q]);
    }
    if (tile != nullptr) {
      *reinterpret_cast<float2*>(tile + e1 * SR + 8 * s + 2 * t) = make_float2(v[0], v[2]);
      *reinterpret_cast<float2*>(tile + e2 * SR + 8 * s + 2 * t) = make_float2(v[1], v[3]);
    }
  }
}

// ------------------------------------------------------------ edge tiles
// The index scratch of one call (ints): the neighbour bits (G N words of
// ceil(N/32)), the edge counts by key (G N), then by item its tiles and its
// first tile, then the item of every tile.
struct Lists {
  uint32_t* bits;
  int* cnt;
  int* item_tiles;
  int* item_start;
  int* tile_item;
  int items, per_graph;
};

__host__ __device__ Lists lists_of(int* p, int G, int n) {
  Lists l;
  l.per_graph = (n + KEYS - 1) / KEYS;
  l.items = G * l.per_graph;
  l.bits = reinterpret_cast<uint32_t*>(p); p += (size_t)G * n * words_of(n);
  l.cnt = p; p += (size_t)G * n;
  l.item_tiles = p; p += l.items;
  l.item_start = p; p += l.items;
  l.tile_item = p;
  return l;
}

// A graph's positions, squared norms and mask: 5 n floats of dynamic shared
// memory where they fit beside the write kernel's 1 KB of static shared
// memory (to N = 11,571), else its slice of the state scratch.
constexpr int GRAPH_SMEM = MAX_SMEM - 1024;
__host__ __device__ constexpr size_t graph_floats(int n) { return 5 * (size_t)n; }
bool graph_in_smem(int n) { return graph_floats(n) * sizeof(float) <= GRAPH_SMEM; }

__device__ Smem graph_view(float* smem, float* gstate, int g, int n, const Lists& l) {
  float* st = gstate != nullptr ? gstate + g * graph_floats(n) : smem;
  Smem s = {};
  s.pos = st;
  s.sq = st + 3 * n;
  s.mask = st + 4 * n;
  s.bits = l.bits + (size_t)g * n * words_of(n);
  return s;
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

// Word w of key a's neighbour bits: the sources j of row a (target-major),
// or the targets i whose list holds source a (source-major).
template <bool SOURCE_MAJOR>
__device__ __forceinline__ uint32_t key_bits(const Smem& s, int n, int a, int w) {
  const int words = words_of(n);
  if (!SOURCE_MAJOR) return s.bits[(size_t)a * words + w];
  const int i = 32 * w + (tid() & 31);
  const bool e = i < n && ((s.bits[(size_t)i * words + (a >> 5)] >> (a & 31)) & 1u);
  return __ballot_sync(0xffffffffu, e);
}

// Per graph (one block of THREADS): the neighbour bits, each key's edge
// count and each item's tiles.
template <bool SOURCE_MAJOR>
__global__ void __launch_bounds__(THREADS)
    cfconv_edge_count_kernel(const float* __restrict__ pos, const float* __restrict__ mask, int n,
                             float cutoff, int cap, int cap_mode, float* gstate, int* scratch,
                             int G) {
  extern __shared__ __align__(16) float smem[];
  const Lists l = lists_of(scratch, G, n);
  const int g = blockIdx.x, words = words_of(n);
  const Smem s = graph_view(smem, gstate, g, n, l);
  load_graph(s, pos, mask, g, n);
  row_bits_large(s, n, cutoff, cap, cap_mode, 0, n);
  team_sync();
  int* cnt = l.cnt + (size_t)g * n;
  for (int a = tid(); a < n; a += THREADS) {
    int c = 0;
    if (SOURCE_MAJOR)
      for (int i = 0; i < n; ++i) c += (s.bits[(size_t)i * words + (a >> 5)] >> (a & 31)) & 1u;
    else
      for (int w = 0; w < words; ++w) c += __popc(s.bits[(size_t)a * words + w]);
    cnt[a] = c;
  }
  team_sync();
  for (int b = tid(); b < l.per_graph; b += THREADS) {
    int e = 0;
    for (int a = b * KEYS; a < min(b * KEYS + KEYS, n); ++a) e += cnt[a];
    l.item_tiles[g * l.per_graph + b] = (e + WET - 1) / WET;
  }
}

// Per graph: each item's first tile (the tiles of all items before it, in
// graph-major order), the item of each of its tiles, and its edge records,
// each key's edges compacted by a warp in the list's order, the item's last
// tile padded.
template <bool SOURCE_MAJOR>
__global__ void __launch_bounds__(THREADS)
    cfconv_edge_write_kernel(const float* __restrict__ pos, const float* __restrict__ mask, int n,
                             float cutoff, float* gstate, int* scratch, int G,
                             int4* __restrict__ edges) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red[THREADS / 32];
  const Lists l = lists_of(scratch, G, n);
  const int g = blockIdx.x, warp = tid() >> 5, lane = tid() & 31;
  const Smem s = graph_view(smem, gstate, g, n, l);
  if (gstate == nullptr) load_graph(s, pos, mask, g, n);  // the count kernel left it in gstate
  const int k0 = g * l.per_graph;
  int before = 0;
  for (int k = tid(); k < k0; k += THREADS) before += l.item_tiles[k];
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  if (lane == 0) red[warp] = before;
  team_sync();
  if (tid() == 0) {
    int at = 0;
    for (int w = 0; w < THREADS / 32; ++w) at += red[w];
    for (int b = 0; b < l.per_graph; ++b) {
      l.item_start[k0 + b] = at;
      at += l.item_tiles[k0 + b];
    }
  }
  team_sync();
  const int* cnt = l.cnt + (size_t)g * n;
  for (int b = tid(); b < l.per_graph; b += THREADS) {
    const int start = l.item_start[k0 + b], tiles = l.item_tiles[k0 + b];
    int e = 0;
    for (int a = b * KEYS; a < min(b * KEYS + KEYS, n); ++a) e += cnt[a];
    for (int t = 0; t < tiles; ++t) l.tile_item[start + t] = k0 + b;
    for (size_t slot = (size_t)start * WET + e; slot < (size_t)(start + tiles) * WET; ++slot)
      edges[slot] = make_int4(PAD_KEY, 0, 0, 0);
  }
  const uint32_t lt = (1u << lane) - 1u;
  const int words = words_of(n);
  for (int a = warp; a < n; a += THREADS / 32) {
    const int b = a / KEYS;
    size_t slot = (size_t)l.item_start[k0 + b] * WET;
    for (int a2 = b * KEYS; a2 < a; ++a2) slot += cnt[a2];
    for (int w = 0; w < words; ++w) {
      const uint32_t bits = key_bits<SOURCE_MAJOR>(s, n, a, w);
      const int other = 32 * w + lane;
      if ((bits >> lane) & 1u) {
        const int i = SOURCE_MAJOR ? other : a, j = SOURCE_MAJOR ? a : other;
        const float d = pair_dist(s.pos, s.sq, i, j);
        const float gate = 0.5f * (cosf(d * PI_F / cutoff) + 1.f);
        edges[slot + __popc(bits & lt)] =
            make_int4(a, other, __float_as_int(d), __float_as_int(gate));
      }
      slot += __popc(bits);
    }
  }
}

// The tiles of work item p of P: about T / P of them, cut at item
// boundaries (an item's tiles go to the run its first tile falls in).
struct Run {
  int lo, hi;
};

__device__ int item_bound(const Lists& l, int T, long long b) {
  if (b >= T) return T;
  const int k = l.tile_item[b], s = l.item_start[k];
  return s == b ? (int)b : s + l.item_tiles[k];
}

__device__ int total_tiles(const Lists& l) {
  return l.items > 0 ? l.item_start[l.items - 1] + l.item_tiles[l.items - 1] : 0;
}

__device__ Run whole_items(const Lists& l, int P, int p) {
  const int T = total_tiles(l);
  return {item_bound(l, T, (long long)p * T / P), item_bound(l, T, (long long)(p + 1) * T / P)};
}

// Tile t's 64 records into a ring stage (one 16-byte cp.async each of the
// warpgroup's first 64 threads).
__device__ __forceinline__ void fetch_tile(int4* stage, const int4* __restrict__ edges, int t) {
  const int k = threadIdx.x & (WG - 1);
  if (k < WET) cp_async16(stage + k, edges + (size_t)t * WET + k);
  cp_async_commit();
}

// ------------------------------------------------------------ K1 and dx
// A block computes FO output filters (its slab) from all F channels of h,
// layer 1 and layer 2 in passes of HC = 64 channels of h, layer 2 into one
// accumulator of the slab's FO filters. At F = 128 the RBF is recomputed
// for each pass (its split fragments, 64 registers at 64 Gaussians, would
// live beside the accumulator); at F = 256 it is computed once. The
// message goes to the row sums MC columns at a time.
template <int F_, int KG_>
struct MsgCfg {
  static constexpr int F = F_, KG = KG_;
  static constexpr int FO = F == 128 ? 128 : 64;
  static constexpr int NS = F / FO;
  static constexpr int HC = 64;
  static constexpr bool RBF_EACH_PASS = KG > 16;
  static constexpr int MC = 32;
  static constexpr int SM = MC + 8;  // the message chunk's row stride
  static constexpr int RING = 2 * WET * 4;
  static constexpr int TEAM_FLOATS = RING + WET * SM;
  static constexpr int WEIGHT_WORDS = 2 * F * KG + 2 * FO * F;
  static constexpr size_t SMEM = (size_t)(WEIGHT_WORDS + TEAMS2 * TEAM_FLOATS) * sizeof(float);
  static_assert(SMEM <= MAX_SMEM, "shared memory of one block");
  static_assert(F % HC == 0 && FO % MC == 0 && KG % 8 == 0, "the passes below");
};

// out[g, key, o0 + c] for the FO columns of a key's row sums, lane c of each
// 32; out is f32.
template <int F, int FO, int MC>
__device__ __forceinline__ void put_rows(float* __restrict__ out, const float (&rows)[FO / MC],
                                         int g, int key, int n, int o0, int lane) {
  if (key >= n) return;
  float* p = out + ((size_t)g * n + key) * F + o0 + lane;
#pragma unroll
  for (int m = 0; m < FO / MC; ++m) p[m * MC] = rows[m];
}

// Columns col0 + 8 i + 2 t (+ 1), i < W / 8, of rows row1 and row2 of a
// node-feature tensor of F columns, widened: this thread's accumulator
// positions of edges e1 and e2. Issued ahead of the products they follow.
template <int W, int F>
__device__ __forceinline__ void gather_pairs(float2 (&v)[W / 8][2], const void* __restrict__ src,
                                             int dtype, size_t row1, size_t row2, int col0) {
  const int c = col0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    v[i][0] = load_feat2(src, row1 * F + c + 8 * i, dtype);
    v[i][1] = load_feat2(src, row2 * F + c + 8 * i, dtype);
  }
}

// The message (W + b2) gate x of columns m MC .. of the slab (the
// accumulator acc of all its filters, xv the gathered rows at those
// columns) into the row sums rows[m]: through the team's chunk of shared
// memory, warp w summing key key0 + w's run [lo, hi) of the tile.
template <int M, int MC, int SM, int FO>
__device__ __forceinline__ void row_sums(float* msg, const float (&acc)[FO / 2],
                                         const float2 (&xv)[MC / 8][2],
                                         const float* __restrict__ b2, float gate1, float gate2,
                                         int e1, int e2, int lo, int hi, float& row) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < MC / 8; ++j) {
    const int i = M * MC / 8 + j, c = 8 * j + 2 * t4;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + M * MC + c));
    *reinterpret_cast<float2*>(msg + e1 * SM + c) =
        make_float2((acc[4 * i] + bb.x) * gate1 * xv[j][0].x,
                    (acc[4 * i + 1] + bb.y) * gate1 * xv[j][0].y);
    *reinterpret_cast<float2*>(msg + e2 * SM + c) =
        make_float2((acc[4 * i + 2] + bb.x) * gate2 * xv[j][1].x,
                    (acc[4 * i + 3] + bb.y) * gate2 * xv[j][1].y);
  }
  wg_sync();
  float sum = row;
  for (int e = lo; e < hi; ++e) sum += msg[e * SM + lane];
  row = sum;
  wg_sync();  // the chunk is read before the next one is written
}

// out[g, key] = sum over the key's edges e of W(d_e) gate_e src[g, other_e],
// W = ssp(rbf W1 + b1) W2 + b2: K1 (keys are targets i, src is x) and K2's
// dx (keys are sources j, src is the cotangent).
template <int F, int KG>
__device__ __forceinline__ void msg_body(const int4* __restrict__ edges, int* scratch, int G,
                                         const void* __restrict__ src, int dtype,
                                         const float* __restrict__ w1, const float* __restrict__ b1,
                                         const float* __restrict__ w2, const float* __restrict__ b2,
                                         float* __restrict__ out, int n, int gs, float cutoff) {
  using C = MsgCfg<F, KG>;
  constexpr int FO = C::FO, HC = C::HC, MC = C::MC, SM = C::SM;
  extern __shared__ __align__(128) float smem[];
  uint32_t* w1b = reinterpret_cast<uint32_t*>(smem);
  uint32_t* w1s = w1b + F * KG;
  uint32_t* w2b = w1s + F * KG;
  uint32_t* w2s = w2b + FO * F;
  float* mine = smem + C::WEIGHT_WORDS + wg() * C::TEAM_FLOATS;
  int4* ring = reinterpret_cast<int4*>(mine);
  float* msg = mine + C::RING;
  const Lists l = lists_of(scratch, G, n);
  const int slab = blockIdx.x % C::NS, member = blockIdx.x / C::NS, members = gridDim.x / C::NS;
  const int o0 = slab * FO;
  stage_b(w1b, w1s, w1, F, 1, KG, gs, F);       // B(k, c) = W1[k][c]
  stage_b(w2b, w2s, w2 + o0, F, 1, F, F, FO);   // B(c, o) = W2[c][o0 + o]
  fence_async_smem();
  __syncthreads();

  const int wt = threadIdx.x & (WG - 1), w = wt >> 5, lane = wt & 31, t4 = lane & 3;
  const int e1 = 16 * w + (lane >> 2), e2 = e1 + 8;
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const uint64_t d1b = bdesc(w1b, KG), d1s = bdesc(w1s, KG);
  const uint64_t d2b = bdesc(w2b, F), d2s = bdesc(w2s, F);
  const Run run = whole_items(l, members * TEAMS2, member * TEAMS2 + wg());
  float rows[FO / MC];
  int cur = -1, gidx = 0, key0 = 0;
  if (run.lo < run.hi) fetch_tile(ring, edges, run.lo);
  for (int t = run.lo; t < run.hi; ++t) {
    const int4* E = ring + ((t - run.lo) & 1) * WET;
    cp_async_wait_all();
    wg_sync();  // tile t's records are in; every warp is done with tile t - 1
    if (t + 1 < run.hi) fetch_tile(ring + (((t - run.lo) & 1) ^ 1) * WET, edges, t + 1);
    const int item = l.tile_item[t];
    if (item != cur) {
      if (cur >= 0) put_rows<F, FO, MC>(out, rows, gidx, key0 + w, n, o0, lane);
      cur = item, gidx = item / l.per_graph, key0 = (item % l.per_graph) * KEYS;
#pragma unroll
      for (int m = 0; m < FO / MC; ++m) rows[m] = 0.f;
    }
    const int4 r1 = E[e1], r2 = E[e2];
    const size_t row1 = (size_t)gidx * n + r1.y, row2 = (size_t)gidx * n + r2.y;
    const float gate1 = __int_as_float(r1.w), gate2 = __int_as_float(r2.w);
    int lo, hi;  // the tile's edges of key key0 + w: a run, the tile being sorted by key
    {
      const int key = key0 + w, ka = E[lane].x, kb = E[lane + 32].x;
      lo = __popc(__ballot_sync(~0u, ka < key)) + __popc(__ballot_sync(~0u, kb < key));
      hi = __popc(__ballot_sync(~0u, ka <= key)) + __popc(__ballot_sync(~0u, kb <= key));
    }
    // -- the gathered rows of the first message chunk, then layer 1 and layer 2 on the tensor cores
    float2 xv[2][MC / 8][2];  // two chunks' rows: the next in flight while one is summed
    gather_pairs<MC, F>(xv[0], src, dtype, row1, row2, o0);
    uint32_t rb[KG / 8][4], rs[KG / 8][4];
    const float d1 = __int_as_float(r1.z), d2 = __int_as_float(r2.z);
    if constexpr (!C::RBF_EACH_PASS)
      rbf_frag<KG, 0>(rb, rs, d1, d2, e1, e2, gs, cutoff, step, coeff, nullptr);
    float acc2[FO / 2];
    static_for<0, F / HC>([&](auto pass) {
      constexpr int q = decltype(pass)::value;
      if constexpr (C::RBF_EACH_PASS)
        rbf_frag<KG, 0>(rb, rs, d1, d2, e1, e2, gs, cutoff, step, coeff, nullptr);
      float acc1[HC / 2];
      wg_fence();
      mma3<true>(acc1, rb[0], rs[0], d1b + q * HC * KG / 4, d1s + q * HC * KG / 4);
#pragma unroll
      for (int s = 1; s < KG / 8; ++s)
        if (8 * s < gs) mma3<false>(acc1, rb[s], rs[s], d1b + q * HC * KG / 4 + 16 * s,
                                    d1s + q * HC * KG / 4 + 16 * s);
      wg_commit();
      wg_wait_all();
      fence_regs(acc1);
      uint32_t hb[HC / 8][4], hs[HC / 8][4];
      afrags(hb, hs, [&](int i) {
        return ssp_fast(acc1[i] + __ldg(b1 + q * HC + 8 * (i >> 2) + 2 * t4 + (i & 1)));
      });
      wg_fence();
#pragma unroll
      for (int s = 0; s < HC / 8; ++s) {
        constexpr int k0 = q * HC / 8;
        if (q == 0 && s == 0) mma3<true>(acc2, hb[s], hs[s], d2b, d2s);
        else mma3<false>(acc2, hb[s], hs[s], d2b + 16 * (k0 + s), d2s + 16 * (k0 + s));
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc2);
    });
    // -- the message and its row sums, MC columns at a time
    static_for<0, FO / MC>([&](auto chunk) {
      constexpr int m = decltype(chunk)::value;
      if constexpr (m + 1 < FO / MC)
        gather_pairs<MC, F>(xv[(m + 1) & 1], src, dtype, row1, row2, o0 + (m + 1) * MC);
      row_sums<m, MC, SM, FO>(msg, acc2, xv[m & 1], b2 + o0, gate1, gate2, e1, e2, lo, hi, rows[m]);
    });
  }
  if (cur >= 0) put_rows<F, FO, MC>(out, rows, gidx, key0 + w, n, o0, lane);
}

// K1 (src = x over the target-major tiles) and K2's dx (src = the
// cotangent over the source-major tiles): one kernel, so one build of the
// body a width.
template <int F, int KG>
__global__ void __launch_bounds__(TEAMS2 * WG, 1)
    cfconv_msg_wgmma_kernel(const int4* __restrict__ edges, int* scratch, int G,
                            const void* __restrict__ src, int dtype, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2, float* __restrict__ out, int n, int gs,
                            float cutoff) {
  msg_body<F, KG>(edges, scratch, G, src, dtype, w1, b1, w2, b2, out, n, gs, cutoff);
}

// ------------------------------------------------------------ K2's weights
// A block (one warpgroup) takes CB channels c0 .. of h and CB filters q0 ..
// of W (its type, one of NT); the blocks of a type split the tiles of the
// source-major list evenly. Compiled at F = 256 only: K2 at F = 128 takes
// csrc/cfconv_large.cu's kernel (ops/cuda/cfconv.py::route). Two blocks an
// SM, the records and rows loaded by the threads.
template <int F_, int KG_>
struct GradCfg {
  static constexpr int F = F_, KG = KG_;
  static constexpr int CB = 64, NB = F / CB, NT = NB * NB;
  static constexpr int BLOCKS = 2;
  // the split, edge-contiguous operands of P4 and P5: h^T (then dpre^T) and
  // dW^T, CB x WET each, and the RBF^T, KG x WET, big and small parts
  static constexpr int HT = 2 * CB * WET, DWT = 2 * CB * WET, RBT = 2 * KG * WET;
  static constexpr int TILE_WORDS = HT + DWT + RBT;
  static constexpr int WEIGHT_WORDS = 2 * CB * KG + 2 * CB * CB;
  static constexpr size_t SMEM = (size_t)(WEIGHT_WORDS + TILE_WORDS) * sizeof(float);
  static_assert(BLOCKS * (SMEM + 1024) <= MAX_SMEM + 1024, "shared memory of the blocks of an SM");
  // a block's partials: dW2's block (CB x CB), dW1's (KG x CB), db1, db2
  static constexpr int PARTIAL = CB * CB + KG * CB + 2 * CB;
  static_assert(SMEM <= MAX_SMEM, "shared memory of one block");
};

// Element (row r, edge e) of an edge-contiguous split operand, its parts.
__device__ __forceinline__ void put_t(uint32_t* big, uint32_t* small, int r, int e, uint32_t b,
                                      uint32_t sm) {
  const int o = bofs(r, e, WET);
  big[o] = b;
  small[o] = sm;
}
__device__ __forceinline__ void put_t(uint32_t* big, uint32_t* small, int r, int e, float v) {
  uint32_t b, sm;
  split_tf32(v, b, sm);
  put_t(big, small, r, e, b, sm);
}

// The sum over the tile's edges of row r of an edge-contiguous split
// operand (big + small parts), in edge order.
__device__ __forceinline__ float row_sum_t(const uint32_t* big, const uint32_t* small, int r) {
  float sum = 0.f;
#pragma unroll 4
  for (int e0 = 0; e0 < WET; e0 += 4) {
    const int o = bofs(r, e0, WET);
    const uint4 b = *reinterpret_cast<const uint4*>(big + o), sm = *reinterpret_cast<const uint4*>(small + o);
    sum += (__uint_as_float(b.x) + __uint_as_float(sm.x)) + (__uint_as_float(b.y) + __uint_as_float(sm.y)) +
           (__uint_as_float(b.z) + __uint_as_float(sm.z)) + (__uint_as_float(b.w) + __uint_as_float(sm.w));
  }
  return sum;
}

// The weight gradients of the edge tiles: P1 (pre = rbf W1 + b1) and P3
// (dh = dW W2^T) from the tile's operands in registers, P4 (dW2 += h^T dW)
// and P5 (dW1 += rbf^T dpre) from edge-contiguous split tiles in shared
// memory, all on wgmma; db1 and db2 from the same tiles.
template <int F, int KG>
__global__ void __launch_bounds__(WG, GradCfg<F, KG>::BLOCKS)
    cfconv_dw_wgmma_kernel(const int4* __restrict__ edges, int* scratch, int G,
                           const void* __restrict__ x, const void* __restrict__ gout, int dtype,
                           const float* __restrict__ w1, const float* __restrict__ b1,
                           const float* __restrict__ w2, float* __restrict__ partial, int n,
                           int gs, float cutoff) {
  using C = GradCfg<F, KG>;
  constexpr int CB = C::CB;
  extern __shared__ __align__(128) float smem[];
  uint32_t* w1b = reinterpret_cast<uint32_t*>(smem);
  uint32_t* w1s = w1b + CB * KG;
  uint32_t* w2b = w1s + CB * KG;
  uint32_t* w2s = w2b + CB * CB;
  uint32_t* htb = w2s + CB * CB;  // h^T, then dpre^T
  uint32_t* hts = htb + CB * WET;
  uint32_t* dwb = hts + CB * WET;                                // dW^T
  uint32_t* dws = dwb + CB * WET;
  uint32_t* rtb = dws + CB * WET;                                // rbf^T
  uint32_t* rts = rtb + KG * WET;
  const Lists l = lists_of(scratch, G, n);
  const int type = blockIdx.x % C::NT, member = blockIdx.x / C::NT, members = gridDim.x / C::NT;
  const int cb = type / C::NB, c0 = cb * CB, q0 = (type % C::NB) * CB;
  stage_b(w1b, w1s, w1 + c0, F, 1, KG, gs, CB);                   // B(k, c) = W1[k][c0 + c]
  stage_b(w2b, w2s, w2 + (size_t)c0 * F + q0, 1, F, CB, CB, CB);  // B(c', c) = W2[c0 + c][q0 + c']
  fence_async_smem();
  __syncthreads();

  const int wt = threadIdx.x, w = wt >> 5, lane = wt & 31, g8 = lane >> 2, t4 = lane & 3;
  const int e1 = 16 * w + g8, e2 = e1 + 8;
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);
  const uint64_t d1b = bdesc(w1b, KG), d1s = bdesc(w1s, KG);
  const uint64_t d2b = bdesc(w2b, CB), d2s = bdesc(w2s, CB);
  const uint64_t dhb = bdesc(htb, WET), dhs = bdesc(hts, WET);
  const uint64_t ddb = bdesc(dwb, WET), dds = bdesc(dws, WET);
  const uint64_t drb = bdesc(rtb, WET), drs = bdesc(rts, WET);
  const int T = total_tiles(l);
  const int lo = (int)((long long)member * T / members), hi = (int)((long long)(member + 1) * T / members);
  // The partials: each tile's P4 and P5 go to an accumulator of their own,
  // added to these on the CUDA cores (round to nearest), so that a sum of
  // a few hundred tiles does not collect the tensor cores' accumulation
  // error of thousands of k-steps.
  float dw2[CB / 2], dw1[KG / 2];
  zero_acc(dw2);
  zero_acc(dw1);
  float db1 = 0.f, db2 = 0.f;  // db2 for threads < CB (filter q0 + wt), db1 for the rest
  const size_t gbase = (size_t)n;  // graph g's rows start at g n

  for (int t = lo; t < hi; ++t) {
    float2 gv[CB / 8][2], xv[CB / 8][2];  // g_i and x_j at the block's filters
    wg_sync();  // tile t - 1 is done with the tiles
    const int4 r1 = __ldg(edges + (size_t)t * WET + e1), r2 = __ldg(edges + (size_t)t * WET + e2);
    const size_t base = (l.tile_item[t] / l.per_graph) * gbase;
    gather_pairs<CB, F>(gv, gout, dtype, base + r1.y, base + r2.y, q0);
    gather_pairs<CB, F>(xv, x, dtype, base + min(r1.x, n - 1), base + min(r2.x, n - 1), q0);
    // -- P3: dh = dW W2[c0 .., q0 ..]^T, dW = gate g_i x_j from the gathered
    // rows at the block's filters; its split parts to dW^T
    float acc3[CB / 2];
    {
      uint32_t gb[CB / 8][4], gsm[CB / 8][4];  // A fragments: (e1, c), (e2, c), (e1, c+1), (e2, c+1)
      const float gate1 = __int_as_float(r1.w), gate2 = __int_as_float(r2.w);
#pragma unroll
      for (int s = 0; s < CB / 8; ++s)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = half ? e2 : e1, c = 8 * s + 2 * t4;
          const float gate = half ? gate2 : gate1;
          const float2 g2 = gv[s][half], x2 = xv[s][half];
          split_tf32((gate * g2.x) * x2.x, gb[s][half], gsm[s][half]);
          split_tf32((gate * g2.y) * x2.y, gb[s][2 + half], gsm[s][2 + half]);
          put_t(dwb, dws, c, e, gb[s][half], gsm[s][half]);
          put_t(dwb, dws, c + 1, e, gb[s][2 + half], gsm[s][2 + half]);
        }
      wg_fence();
#pragma unroll
      for (int s = 0; s < CB / 8; ++s) {
        if (s == 0) mma3<true>(acc3, gb[s], gsm[s], d2b, d2s);
        else mma3<false>(acc3, gb[s], gsm[s], d2b + 16 * s, d2s + 16 * s);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc3);
    }
    // -- P1: pre = rbf W1[:, c0 ..] + b1; the RBF's split parts to rbf^T
    {
      float acc1[CB / 2];
      uint32_t rb[KG / 8][4], rs[KG / 8][4];
      rbf_frag<KG, 0>(rb, rs, __int_as_float(r1.z), __int_as_float(r2.z), e1, e2, gs, cutoff, step,
                      coeff, nullptr);
      wg_fence();
      mma3<true>(acc1, rb[0], rs[0], d1b, d1s);
#pragma unroll
      for (int s = 1; s < KG / 8; ++s)
        if (8 * s < gs) mma3<false>(acc1, rb[s], rs[s], d1b + 16 * s, d1s + 16 * s);
      wg_commit();
#pragma unroll
      for (int s = 0; s < KG / 8; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          put_t(rtb, rts, 8 * s + 2 * t4 + (q >> 1), (q & 1) ? e2 : e1, rb[s][q], rs[s][q]);
      wg_wait_all();
      fence_regs(acc1);
      // h = ssp(pre) to h^T; dpre = dh ssp'(pre) = dh sigmoid(pre)
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const float pre = acc1[i] + __ldg(b1 + c0 + c);
        const float tn = exp_neg_abs(pre), r = rcp_approx(1.f + tn);
        acc3[i] *= pre >= 0.f ? r : tn * r;
        put_t(htb, hts, c, (i & 2) ? e2 : e1, ssp_t(pre, tn));
      }
    }
    fence_async_smem();
    wg_sync();  // h^T, dW^T and rbf^T are in
    // -- P4: dW2[c0 .., q0 ..] += h^T dW
    {
      float tw[CB / 2];
      wg_fence();
      mma3_ss<true>(tw, dhb, dhs, ddb, dds);
#pragma unroll
      for (int s = 1; s < WET / 8; ++s)
        mma3_ss<false>(tw, dhb + 16 * s, dhs + 16 * s, ddb + 16 * s, dds + 16 * s);
      wg_commit();
      if (cb == 0 && wt < CB) db2 += row_sum_t(dwb, dws, wt);
      wg_wait_all();
      fence_regs(tw);
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) dw2[i] += tw[i];
    }
    // dpre to dpre^T (h^T's place: P4 is done with it)
#pragma unroll
    for (int i = 0; i < CB / 2; ++i)
      put_t(htb, hts, 8 * (i >> 2) + 2 * t4 + (i & 1), (i & 2) ? e2 : e1, acc3[i]);
    fence_async_smem();
    wg_sync();
    // -- P5: dW1[:, c0 ..]^T += dpre^T rbf
    {
      float tw[KG / 2];
      wg_fence();
      mma3_ss<true>(tw, dhb, dhs, drb, drs);
#pragma unroll
      for (int s = 1; s < WET / 8; ++s)
        mma3_ss<false>(tw, dhb + 16 * s, dhs + 16 * s, drb + 16 * s, drs + 16 * s);
      wg_commit();
      if (wt >= CB) db1 += row_sum_t(htb, hts, wt - CB);
      wg_wait_all();
      fence_regs(tw);
#pragma unroll
      for (int i = 0; i < KG / 2; ++i) dw1[i] += tw[i];
    }
  }

  float* out = partial + (size_t)blockIdx.x * C::PARTIAL;
#pragma unroll
  for (int i = 0; i < CB / 2; ++i)
    out[(16 * w + g8 + 8 * ((i >> 1) & 1)) * CB + 8 * (i >> 2) + 2 * t4 + (i & 1)] = dw2[i];
#pragma unroll
  for (int i = 0; i < KG / 2; ++i)
    out[CB * CB + (8 * (i >> 2) + 2 * t4 + (i & 1)) * CB + 16 * w + g8 + 8 * ((i >> 1) & 1)] = dw1[i];
  if (wt >= CB) out[CB * CB + KG * CB + wt - CB] = db1;
  else out[CB * CB + KG * CB + CB + wt] = db2;
}

// Sums the warpgroups' partials: an element of dW2 over the warpgroups of
// its block type, of dW1 and db1 over those of every type of its channel
// block, of db2 over those of channel block 0; in type, block, warpgroup
// order. One thread an element.
template <int F, int KG>
__global__ void cfconv_dw_reduce_kernel(const float* __restrict__ partial, int members, int gs,
                                        float* __restrict__ dw1, float* __restrict__ db1,
                                        float* __restrict__ dw2, float* __restrict__ db2) {
  using C = GradCfg<F, KG>;
  constexpr int CB = C::CB, NB = C::NB;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * F + gs * F + 2 * F) return;
  int cb, t0, t1, at;  // channel block, types t0 <= type < t1 (stride 1), offset
  float* dst;
  if (idx < F * F) {
    const int c = idx / F, q = idx % F;
    cb = c / CB, t0 = cb * NB + q / CB, t1 = t0 + 1, at = (c % CB) * CB + q % CB, dst = dw2 + idx;
  } else if (idx < F * F + gs * F) {
    const int i = idx - F * F, k = i / F, c = i % F;
    cb = c / CB, t0 = cb * NB, t1 = t0 + NB, at = CB * CB + k * CB + c % CB, dst = dw1 + i;
  } else if (idx < F * F + gs * F + F) {
    const int c = idx - F * F - gs * F;
    cb = c / CB, t0 = cb * NB, t1 = t0 + NB, at = CB * CB + KG * CB + c % CB, dst = db1 + c;
  } else {
    const int q = idx - F * F - gs * F - F;
    t0 = q / CB, t1 = t0 + 1, at = CB * CB + KG * CB + CB + q % CB, dst = db2 + q;
  }
  float acc = 0.f;
  for (int type = t0; type < t1; ++type)
    for (int m = 0; m < members; ++m)
      acc += partial[(size_t)(m * C::NT + type) * C::PARTIAL + at];
  *dst = acc;
}

// ------------------------------------------------------------ launches
template <bool SOURCE_MAJOR>
int build_edges_wg(const float* pos, const float* mask, int G, int N, float cutoff, int cap,
                   int cap_mode, int* scratch, int4* edges, float* gstate, cudaStream_t st) {
  const bool smem = graph_in_smem(N);
  const size_t bytes = smem ? graph_floats(N) * sizeof(float) : 0;
  float* state = smem ? nullptr : gstate;
  int code = set_smem(cfconv_edge_count_kernel<SOURCE_MAJOR>, GRAPH_SMEM);
  if (code != 0) return code;
  cfconv_edge_count_kernel<SOURCE_MAJOR><<<G, THREADS, bytes, st>>>(pos, mask, N, cutoff, cap,
                                                                    cap_mode, state, scratch, G);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((code = set_smem(cfconv_edge_write_kernel<SOURCE_MAJOR>, GRAPH_SMEM)) != 0) return code;
  cfconv_edge_write_kernel<SOURCE_MAJOR><<<G, THREADS, bytes, st>>>(pos, mask, N, cutoff, state,
                                                                    scratch, G, edges);
  return (int)cudaGetLastError();
}

template <class T>
int round_into(const float* acc, size_t count, void* dst, cudaStream_t st) {
  return sum_parts<1, T>(acc, count, static_cast<T*>(dst), st);
}

int round_out(const float* acc, size_t count, void* dst, int dtype, cudaStream_t st) {
  if (dtype == 1) return round_into<__nv_bfloat16>(acc, count, dst, st);
  if (dtype == 2) return round_into<__half>(acc, count, dst, st);
  return 0;  // f32: summed in place
}

template <int F, int KG>
int fwd_wg(const float* pos, const float* mask, const void* x, const float* w1, const float* b1,
           const float* w2, const float* b2, void* out, float* out32, int* scratch, int4* edges,
           float* gstate, int G, int N, int Gs, float cutoff, int cap, int cap_mode, int blocks,
           int dtype, cudaStream_t st) {
  using C = MsgCfg<F, KG>;
  float* acc = dtype == 0 ? static_cast<float*>(out) : out32;
  const size_t count = (size_t)G * N * F;
  cudaError_t err;
  if ((err = cudaMemsetAsync(acc, 0, count * sizeof(float), st)) != cudaSuccess) return (int)err;
  int code = build_edges_wg<false>(pos, mask, G, N, cutoff, cap, cap_mode, scratch, edges, gstate, st);
  if (code != 0) return code;
  if ((code = set_smem(cfconv_msg_wgmma_kernel<F, KG>, C::SMEM)) != 0) return code;
  cfconv_msg_wgmma_kernel<F, KG><<<blocks, TEAMS2 * WG, C::SMEM, st>>>(
      edges, scratch, G, x, dtype, w1, b1, w2, b2, acc, N, Gs, cutoff);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return round_out(acc, count, out, dtype, st);
}

template <int F, int KG>
int bwd_wg(const float* pos, const float* mask, const void* x, const float* w1, const float* b1,
           const float* w2, const float* b2, const void* gout, void* dx, float* dx32, float* dw1,
           float* db1, float* dw2, float* db2, float* partial, int* scratch, int4* edges,
           float* gstate, int G, int N, int Gs, float cutoff, int cap, int cap_mode,
           int msg_blocks, int dw_blocks, int dtype, cudaStream_t st) {
  using M = MsgCfg<F, KG>;
  using C = GradCfg<F, KG>;
  float* acc = dtype == 0 ? static_cast<float*>(dx) : dx32;
  const size_t count = (size_t)G * N * F;
  cudaError_t err;
  if ((err = cudaMemsetAsync(acc, 0, count * sizeof(float), st)) != cudaSuccess) return (int)err;
  int code = build_edges_wg<true>(pos, mask, G, N, cutoff, cap, cap_mode, scratch, edges, gstate, st);
  if (code != 0) return code;
  if ((code = set_smem(cfconv_msg_wgmma_kernel<F, KG>, M::SMEM)) != 0) return code;
  cfconv_msg_wgmma_kernel<F, KG><<<msg_blocks, TEAMS2 * WG, M::SMEM, st>>>(
      edges, scratch, G, gout, dtype, w1, b1, w2, b2, acc, N, Gs, cutoff);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((code = set_smem(cfconv_dw_wgmma_kernel<F, KG>, C::SMEM)) != 0) return code;
  cfconv_dw_wgmma_kernel<F, KG><<<dw_blocks, WG, C::SMEM, st>>>(
      edges, scratch, G, x, gout, dtype, w1, b1, w2, partial, N, Gs, cutoff);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = F * F + Gs * F + 2 * F;
  cfconv_dw_reduce_kernel<F, KG><<<(total + 255) / 256, 256, 0, st>>>(
      partial, dw_blocks / C::NT, Gs, dw1, db1, dw2, db2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return round_out(acc, count, dx, dtype, st);
}

// The plan of one call: its work items, a bound on its edge tiles (a row
// keeps at most cap + 1 neighbours under the index rule, cap under the
// nearest, N - 1 at most; each item's last tile adds at most one), the
// index scratch (ints: G N ceil(N/32) bits, G N counts, 2 items by item,
// one by tile), the edge records (4 ints a slot), a graph's state scratch
// where 5 N floats exceed GRAPH_SMEM (G 5 N floats, else 0), the grids
// (the message kernel's about one block an SM, a multiple of its output
// slabs; the weight-gradient kernel's BLOCKS an SM, a multiple of its
// block types) and the weight-gradient partials. The wrapper sizes its
// buffers by it (cfconv_wgmma_plan) and the launches cut their grids by it.
struct Plan {
  long long items, tiles, scratch_ints, edge_ints, state_floats, msg_blocks, dw_blocks,
      partial_floats;
};

template <class M, class C>
Plan plan_for(int G, int N, int cap, int cap_mode, int sms, bool bwd) {
  Plan p;
  const long long per_graph = (N + KEYS - 1) / KEYS;
  const long long per_row = std::max(0, std::min(cap + (cap_mode == 0), N - 1));
  p.items = G * per_graph;
  p.tiles = (long long)G * N * per_row / WET + p.items + 1;
  p.scratch_ints = (long long)G * N * words_of(N) + (long long)G * N + 2 * p.items + p.tiles;
  p.edge_ints = 4LL * WET * p.tiles;
  p.state_floats = graph_in_smem(N) ? 0 : (long long)G * graph_floats(N);
  p.msg_blocks = M::NS * std::max(1, sms / M::NS);
  p.dw_blocks = bwd ? C::NT * std::max(1, sms * C::BLOCKS / C::NT) : 0;
  p.partial_floats = p.dw_blocks * C::PARTIAL;
  return p;
}

// K1 at both widths, K2 at F = 256 (bwd): the compiled configurations.
bool plan_of(int G, int N, int F, int Gs, int cap, int cap_mode, int sms, bool bwd, Plan& p) {
  if (!compiled(F, Gs) || (bwd && F != 256) || G < 1 || N < 1 || cap < 0 || sms < 1 ||
      cap_mode < 0 || cap_mode > 1)
    return false;
  using C = GradCfg<256, 16>;
  p = F == 128 ? plan_for<MsgCfg<128, 64>, C>(G, N, cap, cap_mode, sms, false)
               : plan_for<MsgCfg<256, 16>, C>(G, N, cap, cap_mode, sms, bwd);
  return true;
}

}  // namespace

extern "C" {

// The plan of a call (Plan's eight counts, in its order, into out): K1
// (bwd 0) at F = 128 or 256, or K2 (bwd 1) at F = 256, for G graphs of N
// atoms, Gs Gaussians, the neighbour cap and its mode, on a card of `sms`
// SMs. Returns 0, or cudaErrorInvalidValue for a configuration the route
// does not take.
int cfconv_wgmma_plan(int G, int N, int F, int Gs, int cap, int cap_mode, int sms, int bwd,
                      long long* out) {
  Plan p;
  if (!plan_of(G, N, F, Gs, cap, cap_mode, sms, bwd != 0, p)) return (int)cudaErrorInvalidValue;
  const long long v[8] = {p.items, p.tiles, p.scratch_ints, p.edge_ints, p.state_floats,
                          p.msg_blocks, p.dw_blocks, p.partial_floats};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}

// K1 above 128 atoms: cfconv_fwd's arguments, the index scratch, the edge
// records and the graph state scratch (null where the plan's state_floats
// is 0), each of the size cfconv_wgmma_plan(G, N, F, Gs, cap, cap_mode,
// sms, 0) gives; the grid is the plan's.
int cfconv_fwd_wgmma(const float* pos, const float* mask, const void* x, const float* w1,
                     const float* b1, const float* w2, const float* b2, void* out, float* out32,
                     int* scratch, int* edges, float* gstate, int G, int N, int F, int Gs,
                     float cutoff, int cap, int cap_mode, int sms, int dtype, void* stream) {
  Plan p;
  if (!plan_of(G, N, F, Gs, cap, cap_mode, sms, false, p) || !valid_modes(dtype, cap_mode) ||
      (p.state_floats > 0 && gstate == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int4* e = reinterpret_cast<int4*>(edges);
  const int blocks = (int)p.msg_blocks;
  if (F == 128)
    return fwd_wg<128, 64>(pos, mask, x, w1, b1, w2, b2, out, out32, scratch, e, gstate, G, N, Gs,
                           cutoff, cap, cap_mode, blocks, dtype, st);
  return fwd_wg<256, 16>(pos, mask, x, w1, b1, w2, b2, out, out32, scratch, e, gstate, G, N, Gs,
                         cutoff, cap, cap_mode, blocks, dtype, st);
}

// K2 above 128 atoms at F = 256: cfconv_bwd's arguments with an f32
// (G, N, F) scratch dx32 for the bf16 and f16 variants (else null), the
// partials and K1's scratches, each of the size cfconv_wgmma_plan(G, N,
// 256, Gs, cap, cap_mode, sms, 1) gives; the grids are the plan's.
int cfconv_bwd_wgmma(const float* pos, const float* mask, const void* x, const float* w1,
                     const float* b1, const float* w2, const float* b2, const void* gout, void* dx,
                     float* dx32, float* dw1, float* db1, float* dw2, float* db2, float* partial,
                     int* scratch, int* edges, float* gstate, int G, int N, int F, int Gs,
                     float cutoff, int cap, int cap_mode, int sms, int dtype, void* stream) {
  Plan p;
  if (!plan_of(G, N, F, Gs, cap, cap_mode, sms, true, p) || !valid_modes(dtype, cap_mode) ||
      (p.state_floats > 0 && gstate == nullptr))
    return (int)cudaErrorInvalidValue;
  return bwd_wg<256, 16>(pos, mask, x, w1, b1, w2, b2, gout, dx, dx32, dw1, db1, dw2, db2, partial,
                         scratch, reinterpret_cast<int4*>(edges), gstate, G, N, Gs, cutoff, cap,
                         cap_mode, (int)p.msg_blocks, (int)p.dw_blocks, dtype,
                         (cudaStream_t)stream);
}

}  // extern "C"
