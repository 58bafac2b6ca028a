// K3's global route for Hopper (sm_90a): the batched FGW couplings above
// 512 atoms, each solve on a team of CTAs spread across the card, its two
// products on warpgroup matrix multiplies (wgmma).
//
// Replaces, above the stream route's 512 atoms (csrc/fgw.cu holds the
// routes below), the Pallas TPU kernels of conan_fgw_tpu/ops/pallas/fgw.py:
// :269 pallas_fgw_couplings_flat (all S couplings of one outer iteration)
// and :394 pallas_fgw_couplings (one molecule's K couplings against a
// shared barycenter structure, through ops/cuda/fgw.py::fgw_couplings).
// The arithmetic and semantics are csrc/fgw.cu's (its header comment): per
// PGD step A = C1 T, mr = -(2 alpha (constC - A (2 C2)^T) + (1 - alpha) M)
// / eps, log-domain Sinkhorn with the column-marginal check on iterations
// with it % 10 == 0, rollback and diverged flags, the candidate plan's
// finiteness and PGD distance; padding rows and columns (>= n) left out,
// a NaN anywhere in T0 poisons all of mr.
//
// What bounds it. Per solve and PGD step two N^3 products (2 x 2 N^3
// flops; in 3xTF32, three tensor-core passes each) and a few element-wise
// sweeps of N^2 per Sinkhorn iteration: operation-bound on the tensor
// cores, 0.1 ms at S = 15, N = 544 (five PGD steps). The kernel it replaces
// (csrc/fgw.cu's fgw_couplings_large_kernel) ran one CTA a solve, so
// S = 15 solves used 15 of 132 SMs and one SM's share of the TF32 peak put
// five PGD steps at >= 2.6 ms; it loaded every fragment from L1/L2 with
// scalar loads and walked mr, beyond L2 at that size, four times a
// Sinkhorn iteration (18.9 ms there, 0.56% of the bound).
//
// The design:
// - A team of C = ceil(N / R) CTAs a solve (256 threads, two warpgroups,
//   one CTA an SM), CTA r owning rows rR .. rR + R - 1 (R = 64 RT, one
//   wgmma M-tile per row tile; the last band may be short and its empty
//   row tiles are skipped). The grid is persistent: as many whole teams as
//   the card holds at once, team t taking solves t, t + teams, ...
//   team_plan picks RT from (N, S): the fewest rounds times the products'
//   tiles a warpgroup, never leaving one team alone in a last round where
//   a plan with fewer rounds exists (S = 15, N = 544: R = 64 would need 135
//   CTAs, three more than the card's 132 SMs, and a second round for one
//   team; R = 128 holds all 15 teams at once).
// - Co-residency: a cooperative launch (cudaLaunchAttributeCooperative), so
//   that every CTA of the grid is resident or the launch is refused. The
//   team barrier is a per-team arrival counter in the scratch, zeroed on
//   the stream before the launch: a release-ordered add, then an acquire
//   spin. The counter is the only atomic; no float is summed with one.
// - Products on wgmma (m64n64k8, both operands from shared memory), 3xTF32
//   as the other routes (a b ~ a_small b_big + a_big b_small + a_big b_big,
//   f32 sums). Product 1 is C1's band times T, product 2 that band times
//   (2 C2)^T with the epilogue assembling mr from c1p, c2q and M. Each
//   product runs in passes over the columns, a pass holding up to 4 output
//   tiles of 64 x 64 (two a warpgroup, 64 accumulator registers: with
//   three, ptxas spills). A wgmma whose condition
//   the compiler cannot prove warp-uniform is serialized (C7520): the
//   warpgroup index is a warp broadcast. Product 2 needs only the CTA's
//   own band of C1 T, so no team barrier falls between the two products.
// - Every operand is split into big and small TF32 parts (each rounded as
//   cvt.rna.tf32.f32) once, where it is made, and stored in device memory
//   in the ring's own layout: blocks of 64 rows by a k-slice of 32, K-major
//   8-row by 16-byte core matrices, big part then small. C1's and C2's band
//   rows at set-up (C2 shared by the team), C1 T by product 1's epilogue
//   (product 2's A), and T by set-up and by each candidate plan. .tf32
//   takes both operands K-major and T, product 1's B, is row-major: the
//   candidate (four rows a thread at a column) writes its band a second
//   time, transposed and split, so no slice is transposed in the loop.
//   So a k-slice is whole 16 KB blocks: the ring of three stages is filled
//   by bulk copies (cp.async.bulk, TMA without a tensor map) that thread 0
//   issues and that complete on the stage's mbarrier, two k-slices in
//   flight while the wgmma on the third runs; no register holds a staged
//   operand. (A first version split and transposed each slice through
//   registers as it staged it: 255 registers, 574 bytes of spills, 6.13 ms
//   at N = 544, S = 15; 16-byte cp.async copies of the blocks by every
//   thread, 3.69 ms, spilled with a third stage; copying A raw and
//   splitting it in shared memory halved A's bytes and left the time as it
//   was.)
// - Sinkhorn, as the stream route with device memory in place of
//   distributed shared memory: mr's band lives in the scratch; a row's
//   log-sum-exp is local to the band, one pass with a running max and a
//   rescaled sum (chunks of 16); a column's is each band's (max, sum of
//   exp), written to the team's partials, which every CTA then combines in
//   rank order for all N columns with the same arithmetic, so that all
//   hold the same v, bit for bit. One team barrier an iteration: the next
//   iteration's column partials are computed with the new row potentials
//   before it, beside the row flags and the marginal partials; a rollback
//   or freeze ends the loop, so such a guess is never used. The marginal
//   check, the candidate's finiteness and its distance to T are band
//   partials summed in rank order. Exchanged buffers alternate by barrier
//   parity. Every decision is uniform across the team.
// - The candidate plan goes to a second plan buffer in the scratch (with
//   its split transpose); an accepted step swaps the two in every CTA, and
//   the barrier after the candidate makes the new bands visible to the next
//   product 1. The final band is copied to Tout if it lives in the scratch.
// - Bit for bit, run to run: the partition depends only on (N, S) and the
//   card's SM count; no float atomics.
// What is left (clock64 split at N = 544, S = 15, scripts/torch_fgw_probe.py,
// H100 80GB HBM3 at 700 W): the two products take 61% of a CTA's cycles, a
// k-slice about 4,100 cycles against 1,536 of wgmma at the tensor cores'
// rate, waiting on its blocks' copies through L2 (timing variants of an
// earlier version: without the wgmma it ran no faster, without the copies
// 17% faster; bulk copies two slices ahead took a k-slice from 5,400
// cycles to 4,100). The team barriers' waits take 9% (the short last band
// waits longest), the Sinkhorn sweeps 15%, the candidate 7%, set-up 6%.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // two warpgroups
constexpr int TILE = 64;              // a wgmma tile: 64 rows by 64 columns
constexpr int KS = 32;                // a k-slice: four k-steps of 8
constexpr int MAX_RT = 4;             // row tiles a band
constexpr int PASS_TILES = 4;         // output tiles a pass: two a warpgroup
constexpr int RING_TILES = 4;         // row plus column tiles a ring stage holds
constexpr int STAGES = 3;             // ring stages: two k-slices in flight beside the one multiplied
constexpr int BLOCK_WORDS = 2 * TILE * KS;  // a split block: 64 rows by a k-slice, big then small
constexpr int COUNTER_WORDS = 32;     // a team's barrier counter, 128 bytes from the next
constexpr float LOG_EPS = 1e-30f;
constexpr size_t MAX_SMEM_BYTES = 232448;  // a block's dynamic shared memory on Hopper
constexpr int MAX_DEVICES = 64;

// TF32 rounding of cvt.rna.tf32.f32 on the bits of a float that is not
// NaN (csrc/fgw.cu's; a NaN in T0 reaches mr through c1p instead).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

#include "wgmma_tf32.cuh"

// ------------------------------------------------------------ the plan
struct TeamPlan {
  int rt;          // row tiles a band: R = 64 rt
  int ctas;        // C, CTAs a team
  int teams;       // teams at once
  int rounds;      // ceil(S / teams)
  int passes;      // passes over the column tiles a product
  int per_pass;    // P, column tiles a pass
  int vec_smem;    // the vectors in shared memory (else in the scratch)
  size_t smem;     // dynamic shared bytes a CTA
  size_t team_floats;  // scratch floats a team
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// floats of one CTA's vectors: q, log q, c2q, v, vn (N each); log p, c1p,
// u, un (R each); 64 for reductions
__host__ __device__ constexpr size_t vec_floats(int N, int R) {
  return 5 * (size_t)N + 4 * (size_t)R + 64;
}

// words of the ring: STAGES stages, each holding the band's row tiles and
// the pass's column tiles for a k-slice of KS, split, then a stage's
// mbarrier each (16 words for all)
__host__ __device__ constexpr size_t ring_words(int rt, int per_pass) {
  return (size_t)STAGES * (rt + per_pass) * BLOCK_WORDS + 16;
}

// The plan of S solves of N atoms on sms SMs at one CTA an SM; rt = 0
// where none fits. Candidates RT = 1 .. 4 (C <= sms); a pass holds at
// most PASS_TILES tiles and RT + P <= RING_TILES; the cost is rounds times
// a warpgroup's tile passes (ceil(RT P / 2) a pass); a plan whose last
// round holds one team is dropped where another has fewer rounds; ties go
// to fewer rounds, then to the smaller R.
TeamPlan team_plan(int S, int N, int sms) {
  TeamPlan best{};
  if (N < 32 || N % 32 || S < 1 || sms < 1) return best;
  const int NT = cdiv(N, TILE);
  TeamPlan cand[MAX_RT];
  long cost[MAX_RT];
  int found = 0, fewest = 1 << 30;
  for (int rt = 1; rt <= MAX_RT; ++rt) {
    TeamPlan p{};
    p.rt = rt;
    p.ctas = cdiv(N, TILE * rt);
    if (p.ctas > sms) continue;
    p.teams = sms / p.ctas < S ? sms / p.ctas : S;
    p.rounds = cdiv(S, p.teams);
    const int pmax = PASS_TILES / rt < RING_TILES - rt ? PASS_TILES / rt : RING_TILES - rt;
    if (pmax < 1) continue;
    p.passes = cdiv(NT, pmax);
    p.per_pass = cdiv(NT, p.passes);
    const size_t ring = ring_words(rt, p.per_pass) * sizeof(float);
    const size_t vec = vec_floats(N, TILE * rt) * sizeof(float);
    p.vec_smem = ring + vec <= MAX_SMEM_BYTES;
    p.smem = ring + (p.vec_smem ? vec : 0);
    const size_t C = p.ctas, nn = (size_t)N * N;
    // five split matrices of C rt row tiles by N / KS k-slices (C1, C2, C1 T
    // and the two plans' transposes); mr and the second plan; c2q; the
    // column partials (float2) and the marginal partials, two of each by
    // barrier parity; the flags
    size_t f = 5 * C * rt * (N / KS) * (size_t)BLOCK_WORDS + 2 * nn + N + 2 * C * (2 * (size_t)N) +
               2 * C * N + 2 * C * 4;
    if (!p.vec_smem) f += C * vec_floats(N, TILE * rt);
    p.team_floats = (f + 31) / 32 * 32;
    cost[found] = (long)p.rounds * p.passes * cdiv(rt * p.per_pass, 2);
    cand[found++] = p;
    if (p.rounds < fewest) fewest = p.rounds;
  }
  long best_cost = -1;
  for (int i = 0; i < found; ++i) {
    const TeamPlan& p = cand[i];
    const bool lonely = p.rounds > 1 && S - (p.rounds - 1) * p.teams == 1;
    if (lonely && fewest < p.rounds) continue;
    if (best_cost < 0 || cost[i] < best_cost || (cost[i] == best_cost && p.rounds < best.rounds)) {
      best = p;
      best_cost = cost[i];
    }
  }
  return best;
}

// scratch floats of a plan: the teams' barrier counters, then each team's area
size_t plan_scratch_floats(const TeamPlan& p) {
  return (size_t)p.teams * COUNTER_WORDS + (size_t)p.teams * p.team_floats;
}

// ------------------------------------------------------------ device helpers
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// A split matrix: blocks of 64 rows by a k-slice (the ring's layout, bofs
// with K = KS, big part then small), block (row tile, k-slice) at (tile KN
// + slice) BLOCK_WORDS. The word of element (row, k) within its block:
__device__ __forceinline__ size_t split_at(int row, int k, int KN) {
  return ((size_t)(row / TILE) * KN + k / KS) * BLOCK_WORDS + bofs(row % TILE, k % KS, KS);
}

// four values along k (k % 4 == 0), split, at word o of a split matrix
__device__ __forceinline__ void put_split4(uint32_t* m, size_t o, const float4& v) {
  uint4 b, s;
  split_tf32(v.x, b.x, s.x);
  split_tf32(v.y, b.y, s.y);
  split_tf32(v.z, b.z, s.z);
  split_tf32(v.w, b.w, s.w);
  *reinterpret_cast<uint4*>(m + o) = b;
  *reinterpret_cast<uint4*>(m + o + TILE * KS) = s;
}

// two values along k (k % 2 == 0), split, at word o of a split matrix
__device__ __forceinline__ void put_split2(uint32_t* m, size_t o, float x, float y) {
  uint2 b, s;
  split_tf32(x, b.x, s.x);
  split_tf32(y, b.y, s.y);
  *reinterpret_cast<uint2*>(m + o) = b;
  *reinterpret_cast<uint2*>(m + o + TILE * KS) = s;
}

// rows [0, rows) of a row-major N x N matrix (from row r0 on), split into
// the row tiles tile0 .. of a split matrix (rows along the tiles, columns
// along k): 16-byte loads, eight rows by four k a warp's quarter, so that
// the stores fill whole 128-byte lines.
__device__ __forceinline__ void split_rows(uint32_t* m, int tile0, const float* src, int r0, int rows,
                                           int N) {
  const int KN = N / KS, items = cdiv(rows, TILE) * KN * 512;
  for (int e = threadIdx.x; e < items; e += THREADS) {
    const int blk = e >> 9, l = e & 511, tile = blk / KN, ks = blk % KN;
    const int row = TILE * tile + (l >> 6) * 8 + (l & 7), k = KS * ks + 4 * ((l >> 3) & 7);
    if (row < rows)
      put_split4(m, split_at(TILE * tile0 + row, k, KN),
                 __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * N + k)));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Global memory written by the threads (generic proxy), read by bulk
// copies (the async proxy).
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// bytes of bulk copies to land before the barrier's current phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy (a TMA transfer without a tensor map) of bytes from global
// src to shared dst, both 16-byte aligned, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of bar with this parity to complete. A wait of 2^34
// cycles (about 10 s) traps rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// logsumexp's shift: a non-finite max becomes 0, as jax.nn.logsumexp does
__device__ __forceinline__ float lse_shift(float m) { return isfinite(m) ? m : 0.f; }

// (m, s) with s = sum exp(x - lse_shift(m)) over the values added so far;
// adds K more. A NaN reaches s.
template <int K>
__device__ __forceinline__ void online_add(float& m, float& s, const float (&x)[K]) {
  float cm = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) cm = fmaxf(cm, x[k]);
  if (cm > m) {
    if (s != 0.f) s *= expf(lse_shift(m) - lse_shift(cm));
    m = cm;
  }
  const float sh = lse_shift(m);
#pragma unroll
  for (int k = 0; k < K; ++k) s += expf(x[k] - sh);
}

// two running (m, s) pairs as one: a part whose sum is 0 adds nothing
__device__ __forceinline__ void online_merge(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2), sh = lse_shift(M);
  float out = 0.f;
  if (s != 0.f) out += s * expf(lse_shift(m) - sh);
  if (s2 != 0.f) out += s2 * expf(lse_shift(m2) - sh);
  m = M;
  s = out;
}

// The block's sum of v, on every thread. Callers pass a barrier between two
// calls (every reader of red is done before the next call writes it).
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < THREADS / 32; ++k) s += red[k];
  return s;
}

// The team barrier: every CTA's writes before it are visible to every CTA
// of the team after it. count: the barriers this CTA passed before. A wait
// of 2^34 cycles (about 10 s; co-residency rules it out) traps rather than
// holding the card.
__device__ __forceinline__ void team_sync(unsigned* counter, unsigned& count, int C) {
  fence_async_global();  // this thread's stores, before the peers' bulk copies read them
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned target = (count + 1) * (unsigned)C;
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
    const long long start = clock64();
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      if (clock64() - start > (1ll << 34)) __trap();
      __nanosleep(20);
    }
    __threadfence();
    fence_async_global();  // the peers' stores, before this thread's bulk copies
  }
  __syncthreads();
  ++count;
}

// The band's product out(li, j) = sum_k A(li, k) B(k, j) for li < rows,
// j < N, in passes of per_pass column tiles, from the split matrices a (the
// band's row tiles from a_tile0) and b (B's columns as row tiles);
// epi(row tile, column tile, acc) takes each finished tile of this
// warpgroup (acc in wgmma's accumulator layout). The ring's STAGES stages
// rotate, slices x + 1 .. x + STAGES - 1 in flight while the wgmma of
// slice x runs: thread 0 fetches a slice's blocks (16 KB each, contiguous)
// by bulk copies that complete on the stage's mbarrier; phase holds the
// parity each stage's barrier is to reach next.
template <class Epi>
__device__ __forceinline__ void band_product(const uint32_t* a, int a_tile0, const uint32_t* b, int N,
                                             int rows, int rt, int per_pass, int passes,
                                             uint32_t* ring, uint64_t* bars, uint32_t& phase,
                                             Epi&& epi) {
  const int NT = cdiv(N, TILE), KN = N / KS, total = passes * KN;
  const int rte = cdiv(rows, TILE);  // the band's row tiles that hold rows
  const int stage = (rt + per_pass) * BLOCK_WORDS;
  // the warpgroup, warp-uniform as the compiler sees it (a broadcast): a
  // wgmma under a condition that depends on threadIdx alone is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  float acc[2][32];
  auto np_of = [&](int p) { return min(per_pass, NT - p * per_pass); };
  auto fetch = [&](int x, int st) {  // thread 0: slice x into stage st
    const int p = x / KN, ks = x % KN, np = np_of(p);
    uint32_t* buf = ring + st * stage;
    mbar_expect(&bars[st], (uint32_t)((rte + np) * BLOCK_WORDS * sizeof(uint32_t)));
    for (int r = 0; r < rte; ++r)
      bulk_copy(buf + r * BLOCK_WORDS, a + ((size_t)(a_tile0 + r) * KN + ks) * BLOCK_WORDS,
                BLOCK_WORDS * sizeof(uint32_t), &bars[st]);
    for (int c = 0; c < np; ++c)
      bulk_copy(buf + (rt + c) * BLOCK_WORDS,
                b + ((size_t)(p * per_pass + c) * KN + ks) * BLOCK_WORDS,
                BLOCK_WORDS * sizeof(uint32_t), &bars[st]);
  };
  fence_async_global();  // this CTA's stores of the operands, before the copies
  __syncthreads();
  if (threadIdx.x == 0)
    for (int x = 0; x < STAGES - 1 && x < total; ++x) fetch(x, x);
  int st = 0;  // slice x's stage
#pragma unroll 1
  for (int x = 0; x < total; ++x) {
    const int p = x / KN, kq = x % KN, np = np_of(p), tiles = rte * np;
    mbar_wait(&bars[st], (phase >> st) & 1);  // slice x landed
    phase ^= 1u << st;
    __syncthreads();  // every warpgroup is done with slice x - 1
    if (threadIdx.x == 0 && x + STAGES - 1 < total)
      fetch(x + STAGES - 1, st == 0 ? STAGES - 1 : st - 1);  // into slice x - 1's stage
    const uint64_t da = bdesc(ring + st * stage, KS);
    const uint64_t db = bdesc(ring + st * stage + rt * BLOCK_WORDS, KS);
    st = st + 1 == STAGES ? 0 : st + 1;
    wg_fence();
#pragma unroll
    for (int s = 0; s < KS / 8; ++s)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int ti = wg + 2 * t;
        if (ti < tiles) {
          // a block is BLOCK_WORDS / 4 descriptor units, its small part
          // half of that on; a k-step 16
          const uint64_t oa = (uint64_t)(ti / np) * (BLOCK_WORDS / 4) + 16 * s;
          const uint64_t ob = (uint64_t)(ti % np) * (BLOCK_WORDS / 4) + 16 * s;
          constexpr uint64_t SMALL = BLOCK_WORDS / 8;
          if (kq == 0 && s == 0) mma3_ss<true>(acc[t], da + oa, da + oa + SMALL, db + ob, db + ob + SMALL);
          else mma3_ss<false>(acc[t], da + oa, da + oa + SMALL, db + ob, db + ob + SMALL);
        }
      }
    wg_commit();
    wg_wait_all();
    if (kq == KN - 1) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        fence_regs(acc[t]);
        const int ti = wg + 2 * t;
        if (ti < tiles) epi(ti / np, p * per_pass + ti % np, acc[t]);
      }
    }
  }
  __syncthreads();  // every warpgroup is done with the ring
}

// A 4 x 4 block x (rows i .. i + 3 of columns j .. j + 3, i % 4 == 0) into
// the split matrix t of its transpose (rows j, k = i): four 16-byte stores
// of each part.
__device__ __forceinline__ void store_transposed(uint32_t* t, int KN, int j, int i,
                                                 const float4 (&x)[4]) {
  put_split4(t, split_at(j, i, KN), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
  put_split4(t, split_at(j + 1, i, KN), make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
  put_split4(t, split_at(j + 2, i, KN), make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
  put_split4(t, split_at(j + 3, i, KN), make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
}

// ------------------------------------------------------------ the kernel
__global__ void __launch_bounds__(THREADS, 1)
    fgw_couplings_team_kernel(const float* __restrict__ Ms, const float* __restrict__ C1s,
                              const float* __restrict__ C2s, const float* __restrict__ ps,
                              const float* __restrict__ qs, const float* __restrict__ T0s,
                              float* Tout, int* __restrict__ div_out, int* __restrict__ iters_out,
                              float* scratch, int S, int N, int n, int rt, int per_pass,
                              int passes, int vec_smem, size_t team_floats, float alpha,
                              float epsilon, int pgd_iters, float pgd_tol, int sinkhorn_iters,
                              float sinkhorn_thr) {
  extern __shared__ __align__(128) uint32_t smem[];
  const int R = TILE * rt, C = cdiv(N, R), teams = gridDim.x / C;
  const int team = blockIdx.x / C, rank = blockIdx.x % C, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b0 = rank * R, rows = min(R, N - b0);   // the band's rows
  const int nr = max(0, min(rows, n - b0));           // of them, real atoms
  const size_t nn = (size_t)N * N;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch) + team * COUNTER_WORDS;
  float* area = scratch + (size_t)teams * COUNTER_WORDS + team * team_floats;
  const int KN = N / KS, tile0 = b0 / TILE;  // k-slices; the band's first row tile
  const size_t split = (size_t)C * rt * KN * BLOCK_WORDS;  // words of a split matrix
  uint32_t* C1x = reinterpret_cast<uint32_t*>(area);  // C1, split (each CTA its band's rows)
  uint32_t* C2x = C1x + split;                         // C2, split (the team's)
  uint32_t* Ax = C2x + split;                          // C1 T, split (each CTA its band's rows)
  uint32_t* Tx[2] = {Ax + split, Ax + 2 * split};      // the two plans, transposed and split
  float* mr = reinterpret_cast<float*>(Ax + 3 * split);  // -G / eps, the team's bands
  float* Tc = mr + nn;          // the second plan buffer
  float* c2qg = Tc + nn;        // c2q, band by band
  float2* cpart = reinterpret_cast<float2*>(c2qg + N);     // [2][C][N]: a band's (max, sum)
  float* mpart = reinterpret_cast<float*>(cpart + 2 * (size_t)C * N);  // [2][C][N]: marginals
  float* xflag = mpart + 2 * (size_t)C * N;               // [2][C][4]: flags and distances
  uint32_t* ring = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_words(rt, per_pass) - 16);  // one a stage
  uint32_t phase = 0;  // the parity each stage's barrier is to reach next
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float* vec = vec_smem ? reinterpret_cast<float*>(smem + ring_words(rt, per_pass))
                        : xflag + 8 * C + (size_t)rank * vec_floats(N, R);
  float* q = vec;
  float* logq = q + N;
  float* c2q = logq + N;
  float* v = c2q + N;    // column potentials: v accepted, vn the sweep's
  float* vn = v + N;
  float* logp = vn + N;  // the band's rows from here on
  float* c1p = logp + R;
  float* u = c1p + R;    // row potentials: u accepted, un the sweep's
  float* un = u + R;
  float* red = un + R;   // 32
  unsigned count = 0;    // team barriers passed
  auto flags = [&](unsigned par) { return xflag + (size_t)par * 4 * C; };

  for (int s = team; s < S; s += teams) {
    const float* C1 = C1s + s * nn;
    const float* C2 = C2s + s * nn;
    const float* M = Ms + s * nn;
    float* Tcur = Tout + s * nn;  // the plan: T's bands, in Tout or Tc
    float* Tnext = Tc;            // the candidate's buffer
    uint32_t* Txcur = Tx[0];      // their transposes, split: product 1's B
    uint32_t* Txnext = Tx[1];

    // set-up: T's band = T0's without mass on the padding (and its
    // transpose, split), C1's and C2's band rows split, the marginals, c1p
    // of the band's rows and c2q of all (each band's, gathered)
    int t0_nan = 0;  // a NaN in T0: every product entry is NaN in f32
    for (int e = tid; e < rows / 4 * (N / 4); e += THREADS) {
      const int li = 4 * (e / (N / 4)), j = 4 * (e % (N / 4));
      float4 x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = b0 + li + r;
        x[r] = i < n ? __ldg(reinterpret_cast<const float4*>(T0s + s * nn + (size_t)i * N + j))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        if (j + 0 >= n) x[r].x = 0.f;
        if (j + 1 >= n) x[r].y = 0.f;
        if (j + 2 >= n) x[r].z = 0.f;
        if (j + 3 >= n) x[r].w = 0.f;
        t0_nan |= isnan(x[r].x) | isnan(x[r].y) | isnan(x[r].z) | isnan(x[r].w);
        *reinterpret_cast<float4*>(Tcur + (size_t)i * N + j) = x[r];
      }
      store_transposed(Txcur, KN, j, b0 + li, x);
    }
    split_rows(C1x, tile0, C1, b0, rows, N);
    split_rows(C2x, tile0, C2, b0, rows, N);
    float* p = vn;  // the row marginal, needed by set-up alone
    for (int j = tid; j < N; j += THREADS) {
      const float pv = j < n ? __ldg(ps + (size_t)s * N + j) : 0.f;
      const float qv = j < n ? __ldg(qs + (size_t)s * N + j) : 0.f;
      p[j] = pv;
      q[j] = qv;
      logq[j] = logf(fmaxf(qv, LOG_EPS));
      if (j >= b0 && j < b0 + R) logp[j - b0] = logf(fmaxf(pv, LOG_EPS));
    }
    t0_nan = __syncthreads_or(t0_nan);
    // constC[i][j] = c1p[i] + c2q[j]: the band's rows of C1 and of C2, one
    // warp a row
    for (int line = warp; line < 2 * rows; line += THREADS / 32) {
      const bool second = line >= rows;
      const int i = b0 + (second ? line - rows : line);
      const float* row = (second ? C2 : C1) + (size_t)i * N;
      const float* w = second ? q : p;
      float acc = 0.f;
      for (int k = lane; k < N; k += 32) {
        const float x = __ldg(row + k);
        acc = fmaf(x * x, w[k], acc);
      }
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        if (second) c2qg[i] = acc;
        else c1p[line] = acc;
      }
    }
    if (tid == 0) flags(count & 1)[4 * rank] = t0_nan ? 1.f : 0.f;
    team_sync(counter, count, C);  // T's bands, C2's, c2q's and the NaN flags, across the team
    {
      const float* got = flags((count - 1) & 1);
      float any = 0.f;
      for (int r = 0; r < C; ++r) any = fmaxf(any, __ldcg(got + 4 * r));
      for (int j = tid; j < N; j += THREADS) c2q[j] = __ldcg(c2qg + j);
      if (any != 0.f && tid < R) c1p[tid] = __int_as_float(0x7fc00000);  // all of mr NaN
    }

    bool frozen = false, diverged = false;  // uniform across the team
    int sk_run = 0;                         // Sinkhorn iterations run, all PGD steps
    for (int it = 0; it < pgd_iters; ++it) {
      const int wq = (tid & 127) >> 5, g = lane >> 2, t4 = lane & 3;
      // product 1: C1 T into the band's rows of Ax, split (product 2's A)
      band_product(C1x, tile0, Txcur, N, rows, rt, per_pass, passes, ring, bars, phase,
                   [&](int rtile, int ctile, float(&d)[32]) {
                     const int li = TILE * rtile + 16 * wq + g;
#pragma unroll
                     for (int i = 0; i < 8; ++i) {
                       const int j = TILE * ctile + 8 * i + 2 * t4;
                       if (j >= N) continue;
                       if (li < rows)
                         put_split2(Ax, split_at(b0 + li, j, KN), d[4 * i], d[4 * i + 1]);
                       if (li + 8 < rows)
                         put_split2(Ax, split_at(b0 + li + 8, j, KN), d[4 * i + 2], d[4 * i + 3]);
                     }
                   });
      // product 2: mr = -(2 alpha (constC - A (2 C2)^T) + (1 - alpha) M) / eps
      // from the band of A alone (band_product's barriers order its reads
      // after the stores above)
      band_product(Ax, tile0, C2x, N, rows, rt, per_pass, passes, ring, bars, phase,
                          [&](int rtile, int ctile, float(&d)[32]) {
                            const int l0 = TILE * rtile + 16 * wq + g;
#pragma unroll
                            for (int i = 0; i < 8; ++i) {
                              const int j = TILE * ctile + 8 * i + 2 * t4;
                              if (j >= N) continue;
#pragma unroll
                              for (int h = 0; h < 2; ++h) {
                                const int li = l0 + 8 * h, ie = b0 + li;
                                if (li >= rows) continue;
                                const float2 mv =
                                    __ldg(reinterpret_cast<const float2*>(M + (size_t)ie * N + j));
                                float out[2];
#pragma unroll
                                for (int e = 0; e < 2; ++e) {
                                  const int je = j + e;
                                  const float hh = 2.f * d[4 * i + 2 * h + e];
                                  const float tens = alpha * (2.f * ((c1p[li] + c2q[je]) - hh)) +
                                                     (1.f - alpha) * (e ? mv.y : mv.x);
                                  out[e] = ie >= n || je >= n ? -INFINITY : -tens / epsilon;
                                }
                                *reinterpret_cast<float2*>(mr + (size_t)ie * N + j) =
                                    make_float2(out[0], out[1]);
                              }
                              // M's loads two at a time: hoisted all at once,
                              // they spill beside the accumulators
                              asm volatile("" ::: "memory");
                            }
                          });
      // the padding's potentials stay 0 in both buffers of each pair
      for (int j = tid; j < N; j += THREADS) v[j] = 0.f, vn[j] = 0.f;
      for (int i = tid; i < R; i += THREADS) u[i] = 0.f, un[i] = 0.f;
      __syncthreads();
      const float* mrb = mr + (size_t)b0 * N;  // the band of mr

      // the band's (max, sum of exp) of mr[i, j] + uu[i] for every column,
      // one thread a column, rows in chunks of 16 (their loads in flight
      // together: the sweeps wait on L2's latency, not its bandwidth)
      auto col_partials = [&](const float* uu, float2* out) {
        for (int j = tid; j < n; j += THREADS) {
          float m = -INFINITY, sum = 0.f;
          int li = 0;
          for (; li + 16 <= nr; li += 16) {
            float x[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) x[k] = __ldcg(mrb + (size_t)(li + k) * N + j);
#pragma unroll
            for (int k = 0; k < 16; ++k) x[k] += uu[li + k];
            online_add(m, sum, x);
          }
          for (; li < nr; ++li) {
            float x[1] = {__ldcg(mrb + (size_t)li * N + j) + uu[li]};
            online_add(m, sum, x);
          }
          out[j] = make_float2(m, sum);
        }
      };

      // log-domain Sinkhorn
      col_partials(u, cpart + ((count & 1) * C + rank) * (size_t)N);
      team_sync(counter, count, C);
      bool sfrozen = false, sdiv = false;
      for (int si = 0; si < sinkhorn_iters && !sfrozen; ++si) {
        const unsigned rd = (count - 1) & 1;
        // Sinkhorn columns: the team's partials in rank order, in every CTA
        int bad_v = 0;
        for (int j = tid; j < n; j += THREADS) {
          float m = -INFINITY, sum = 0.f;
          for (int r0 = 0; r0 < C; r0 += 8) {  // eight partials' loads in flight
            float2 pr[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r0 + r < C) pr[r] = __ldcg(cpart + (rd * C + r0 + r) * (size_t)N + j);
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r0 + r < C) online_merge(m, sum, pr[r].x, pr[r].y);
          }
          const float out = logq[j] - (logf(sum) + lse_shift(m));
          vn[j] = out;
          bad_v |= !isfinite(out);
        }
        bad_v = __syncthreads_or(bad_v);  // the same in every CTA of the team
        // Sinkhorn rows: local to the band, one warp a row, four 16-byte
        // loads a lane in flight
        int bad_u = 0;
        for (int li = warp; li < nr; li += THREADS / 32) {
          const float* row = mrb + (size_t)li * N;
          float m = -INFINITY, sum = 0.f;
          for (int j0 = 4 * lane; j0 < N; j0 += 512) {
            float x[16];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = j0 + 128 * c;
              float4 x4 = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
              if (j < N) {
                const float4 m4 = ldcg4(row + j);
                const float4 v4 = *reinterpret_cast<const float4*>(vn + j);
                x4 = make_float4(m4.x + v4.x, m4.y + v4.y, m4.z + v4.z, m4.w + v4.w);  // -inf on the padding
              }
              x[4 * c] = x4.x, x[4 * c + 1] = x4.y, x[4 * c + 2] = x4.z, x[4 * c + 3] = x4.w;
            }
            online_add(m, sum, x);
          }
          for (int o = 16; o > 0; o >>= 1)
            online_merge(m, sum, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, sum, o));
          if (lane == 0) {
            const float out = logp[li] - (logf(sum) + lse_shift(m));
            un[li] = out;
            bad_u |= !isfinite(out);
          }
        }
        const bool check = si % 10 == 0, more = si + 1 < sinkhorn_iters;
        if (check || more) __syncthreads();  // un complete
        // the band's column marginals of the would-be plan
        if (check) {
          float* out = mpart + ((count & 1) * C + rank) * (size_t)N;
          for (int j = tid; j < n; j += THREADS) {
            const float vj = vn[j];
            float col = 0.f;
#pragma unroll 8
            for (int li = 0; li < nr; ++li) col += expf(__ldcg(mrb + (size_t)li * N + j) + un[li] + vj);
            out[j] = col;
          }
        }
        // the next iteration's column partials, taking the new row
        // potentials as accepted: a rollback or freeze ends the loop first
        if (more) col_partials(un, cpart + ((count & 1) * C + rank) * (size_t)N);
        bad_u = __syncthreads_or(bad_u);
        if (tid == 0) flags(count & 1)[4 * rank] = bad_u ? 1.f : 0.f;
        team_sync(counter, count, C);
        const float* got = flags((count - 1) & 1);
        float any = 0.f;
        for (int r = 0; r < C; ++r) any = fmaxf(any, __ldcg(got + 4 * r));
        const bool newly_div = bad_v || any != 0.f;  // sfrozen is false here
        bool newly_frozen = newly_div;
        if (check) {
          const float* mp = mpart + ((count - 1) & 1) * C * (size_t)N;
          float e2 = 0.f;
          for (int j = tid; j < n; j += THREADS) {
            float col = 0.f;
#pragma unroll 8
            for (int r = 0; r < C; ++r) col += __ldcg(mp + r * (size_t)N + j);
            const float dlt = col - q[j];
            e2 += dlt * dlt;
          }
          e2 = block_sum(e2, red);
          newly_frozen = newly_frozen || sqrtf(e2) < sinkhorn_thr;
        }
        if (!newly_div) {
          float* x = u;
          u = un, un = x;
          x = v;
          v = vn, vn = x;
        }
        sfrozen = newly_frozen;
        sdiv = sdiv || newly_div;
        ++sk_run;
      }

      // candidate plan, into Tnext (and its transpose, split, into
      // Txnext): its finiteness and distance to T's band, band partials
      // summed across the team in rank order; a thread takes 4 x 4 blocks,
      // so that the transpose's stores are 16 bytes too
      int nonfinite = 0;
      float e2 = 0.f;
      for (int e = tid; e < rows / 4 * (N / 4); e += THREADS) {
        const int li = 4 * (e / (N / 4)), j = 4 * (e % (N / 4));
        const float4 v4 = *reinterpret_cast<const float4*>(v + j);
        float4 m4[4], t4v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          m4[r] = ldcg4(mr + (size_t)(b0 + li + r) * N + j);
          t4v[r] = ldcg4(Tcur + (size_t)(b0 + li + r) * N + j);
        }
        float4 c[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ur = u[li + r];
          c[r] = make_float4(expf(m4[r].x + ur + v4.x), expf(m4[r].y + ur + v4.y),
                             expf(m4[r].z + ur + v4.z), expf(m4[r].w + ur + v4.w));
          nonfinite |= !isfinite(c[r].x) | !isfinite(c[r].y) | !isfinite(c[r].z) | !isfinite(c[r].w);
          const float dx = c[r].x - t4v[r].x, dy = c[r].y - t4v[r].y;
          const float dz = c[r].z - t4v[r].z, dw = c[r].w - t4v[r].w;
          e2 += dx * dx;
          e2 += dy * dy;
          e2 += dz * dz;
          e2 += dw * dw;
          *reinterpret_cast<float4*>(Tnext + (size_t)(b0 + li + r) * N + j) = c[r];
        }
        store_transposed(Txnext, KN, j, b0 + li, c);
      }
      nonfinite = __syncthreads_or(nonfinite);
      const bool check = it % 10 == 0;
      if (check) e2 = block_sum(e2, red);
      if (tid == 0) {
        float* mine = flags(count & 1) + 4 * rank;
        mine[1] = nonfinite ? 1.f : 0.f;
        mine[2] = check ? e2 : 0.f;
      }
      team_sync(counter, count, C);  // also: the candidate's bands, for the next product 1
      const float* got = flags((count - 1) & 1);
      float any = 0.f, dist2 = 0.f;
      for (int r = 0; r < C; ++r) {
        any = fmaxf(any, __ldcg(got + 4 * r + 1));
        dist2 += __ldcg(got + 4 * r + 2);
      }
      const bool bad = sdiv || any != 0.f;
      bool newly_frozen = bad;
      if (check) newly_frozen = newly_frozen || sqrtf(dist2) <= pgd_tol;
      if (!(frozen || bad)) {  // the candidate becomes T, in every CTA of the team
        float* x = Tcur;
        Tcur = Tnext, Tnext = x;
        uint32_t* y = Txcur;
        Txcur = Txnext, Txnext = y;
      }
      frozen = frozen || newly_frozen;
      diverged = diverged || bad;
    }
    // the final plan's band to Tout, where it lives in the scratch
    if (Tcur != Tout + s * nn) {
      for (int li = warp; li < rows; li += THREADS / 32) {
        const size_t at = (size_t)(b0 + li) * N;
        for (int j = 4 * lane; j < N; j += 128)
          *reinterpret_cast<float4*>(Tout + s * nn + at + j) = ldcg4(Tcur + at + j);
      }
    }
    if (rank == 0 && tid == 0) {
      div_out[s] = diverged ? 1 : 0;
      iters_out[s] = sk_run;
    }
  }
}

// the device's SM count, read once per device
int device_sms(int dev) {
  static int sms[MAX_DEVICES];
  if (dev < MAX_DEVICES && sms[dev] > 0) return sms[dev];
  int count = 0;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES) sms[dev] = count;
  return count;
}

}  // namespace

extern "C" {

// The global route's plan of S solves of N atoms on sms SMs (0: the
// current device's): out[0..8] = R, C, teams at once, rounds, passes,
// column tiles a pass, vectors in shared memory, shared bytes a CTA, and
// the plan's scratch floats (as a 32-bit count of 32-float blocks).
// Returns cudaErrorInvalidValue where no plan fits.
int fgw_team_plan(int S, int N, int sms, int* out) {
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidDevice;
    sms = device_sms(dev);
  }
  const TeamPlan p = team_plan(S, N, sms);
  if (!p.rt) return (int)cudaErrorInvalidValue;
  const int vals[9] = {TILE * p.rt, p.ctas, p.teams, p.rounds, p.passes, p.per_pass, p.vec_smem,
                       (int)p.smem, (int)(plan_scratch_floats(p) / 32)};
  for (int k = 0; k < 9; ++k) out[k] = vals[k];
  return 0;
}

// K3's global route, for any N that is a multiple of 32 (the wrapper
// takes it above 512): arguments as fgw_couplings, plus a scratch of the
// plan's floats (fgw_team_plan's out[8] blocks of 32; the teams resident
// at once, not S; 16-byte aligned); Tout must not
// alias an input. Zeroes the teams' barrier counters on the stream, then
// launches cooperatively (every CTA resident, or the launch is refused).
int fgw_couplings_large(const float* Ms, const float* C1s, const float* C2s, const float* ps,
                        const float* qs, const float* T0s, float* Tout, int* div_out,
                        int* iters_out, float* scratch, int S, int N, int n, float alpha,
                        float epsilon, int pgd_iters, float pgd_tol, int sinkhorn_iters,
                        float sinkhorn_thr, void* stream) {
  if (N < 32 || N % 32 || n < 1 || n > N || S < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const TeamPlan p = team_plan(S, N, device_sms(dev));
  if (!p.rt) return (int)cudaErrorInvalidValue;
  static bool raised[MAX_DEVICES];
  if (dev >= MAX_DEVICES || !raised[dev]) {
    err = cudaFuncSetAttribute(fgw_couplings_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) raised[dev] = true;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fgw_couplings_team_kernel, THREADS,
                                                      p.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(scratch, 0, (size_t)p.teams * COUNTER_WORDS * sizeof(float),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)(p.teams * p.ctas));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fgw_couplings_team_kernel, Ms, C1s, C2s, ps, qs, T0s, Tout,
                           div_out, iters_out, scratch, S, N, n, p.rt, p.per_pass, p.passes,
                           p.vec_smem, p.team_floats, alpha, epsilon, pgd_iters, pgd_tol,
                           sinkhorn_iters, sinkhorn_thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
