// Batched entropic-PGD fused Gromov-Wasserstein couplings for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of conan_fgw_tpu/ops/pallas/fgw.py
// (pallas_fgw_couplings_flat -> _super_kernel / _sinkhorn_super).
//
// Four routes, chosen by the bucket size N (ops/cuda/fgw.py::route), each
// with its own comment on what bounds it and how it answers that:
// - N = 32 .. 128: fgw_couplings_kernel<N, PAD>, one CTA a solve, the
//   solve's matrices in that CTA's shared memory (this header);
// - N = 160 .. 256: fgw_couplings_cluster_kernel<N, R>, one thread-block
//   cluster of N / R CTAs a solve, each holding a band of R rows of the
//   solve's matrices in its shared memory;
// - N = 288 .. 512: fgw_couplings_stream_kernel<SUB>, one cluster of N / R
//   CTAs a solve, each holding a band of mr in its shared memory while T
//   and C2 stream through a ring of k-slices;
// - N above 512: csrc/fgw_team.cu's fgw_couplings_team_kernel, each solve
//   on a team of CTAs across the card that cooperate through device memory,
//   the products on wgmma.
//
// S independent solves (square loss, symmetric structure, PGD), each of n
// atoms padded to a bucket size N: rows and columns >= n are left out of the
// solve (their entries of mr are -inf, their potentials stay 0, and they take
// no mass), so a padded solve is the n x n solve, and its plan is 0 on the
// padding. Each PGD step
//   G  = 2 alpha (constC - C1 T (2 C2)^T) + (1 - alpha) M,
//   mr = -G / eps,
// then log-domain Sinkhorn on mr: per-row and per-column log-sum-exp, each
// stabilised by its own max; the column-marginal check on iterations with
// it % 10 == 0 freezes a converged solve, and non-finite potentials roll
// the solve back and flag it as diverged. After Sinkhorn, a non-finite plan
// also counts as a failure, and the PGD update error (checked on it % 10 == 0)
// freezes the solve. Semantics are those of conan_fgw_tpu/ops/fgw/coupling.py.
//
// What bounds it on this card. The bytes are ~5 N^2 floats per solve and the
// flops 2*2N^3 per PGD step plus ~5 exp per element per Sinkhorn iteration:
// at N=32 neither memory nor any peak is near. One solve is a serial chain
// of small products, reductions and barriers, and S = 120 solves fill 120 of
// the 132 SMs with one block each, so the time is one solve's latency. The
// design shortens that chain:
// - one CTA of 256 threads per solve keeps T, C1 T (then the candidate plan)
//   and mr in shared memory for the whole solve, and C1 and C2 too where
//   they fit (N <= 96). At N = 128 C1 and C2 are read through L2 by the
//   same fragment code. M is read once, into registers at the places where
//   product 2's epilogue needs it.
// - set-up issues every load of M, C1, C2, T0 (16-byte loads), p and q
//   before its first shared store; c1p and c2q (constC is their rank-1 sum)
//   are row reductions over all threads with warp shuffles.
// - both products run on the tensor cores (mma.m16n8k8 TF32) with each f32
//   operand split on load into x_big = tf32(x) and x_small = tf32(x - x_big),
//   summing a_small b_big + a_big b_small + a_big b_big in f32: as accurate
//   as the f32 products (one TF32 pass is not). The rounding is that of
//   cvt.rna.tf32.f32, done with an integer add and mask at full rate, which
//   would turn a NaN into -0. A NaN in C1 or C2 still reaches mr through
//   c1p or c2q, on the rows or columns the f32 products would make NaN; a
//   NaN anywhere in T0 makes every entry of the f32 C1 T (2 C2)^T NaN, so
//   set-up makes c1p NaN instead, and with it all of mr. Each warp owns
//   an (N/2) x (N/4) block of the output, (N/32)^2 tiles of 16 x 8. Product
//   2 reads (2 C2)^T straight from C2's rows (C2 need not be symmetric) and
//   assembles mr from its accumulators.
// - the log-sum-exp sweeps and the column-marginal check use all threads,
//   TPR lanes per line with shuffles; the finiteness test rides on the
//   sweeps' barrier; the potentials ping-pong between two buffers.
// What is left (clock64 phase split, scripts/torch_fgw_probe.py, H100 80GB
// HBM3 at 700 W):
// at N = 32 a solve takes ~25k cycles, a third in the products, a third in
// the Sinkhorn sweeps (shuffle and barrier latency, and precise expf/logf,
// about a quarter of a sweep), the rest in the marginal checks, candidate
// plans and set-up; a solve that runs more Sinkhorn iterations spends more
// than half of its time in the sweeps.
// Padded row strides (floats; N is a multiple of 32):
//   LDA = N + 4 for C1, C2, C1 T and mr: an m16n8k8 fragment of a row-major
//     operand reads (row g, col t), g < 8, t < 4: bank 4g + t, conflict-free;
//     so does product 2's B fragment, read from C2's rows. The column walks
//     of the Sinkhorn sweeps are conflict-free at N = 32 and the row walks at
//     N = 64; the other walks, and product 1's float2 stores, are 2-way.
//   LDT = N + 8 for T, read as product 1's k-major B operand at (row t,
//     col g): bank 8t + g, conflict-free.
// The TPU's lane packing, block-diagonal operands and selector matmuls are
// dropped: they served the TPU layout only.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOG_EPS = 1e-30f;
constexpr int MAX_DEVICES = 64;
constexpr size_t MAX_SMEM_BYTES = 232448;  // a block's dynamic shared memory on Hopper

// shared floats of one solve: T, C1 T and mr, the vectors, and C1 and C2
// when resident
__host__ __device__ constexpr size_t smem_floats(int n, int resident) {
  return (size_t)n * (n + 8) + (size_t)(2 + 2 * resident) * n * (n + 4) + 10 * n + 32;
}

// lanes that share one line (row or column) of a log-sum-exp sweep: the
// largest power of two <= 32 that leaves a line for every lane group
__host__ __device__ constexpr int lse_tpr(int n) {
  int t = 1;
  while (t < 32 && t * 2 * n <= THREADS) t *= 2;
  return t;
}

// lanes per row of the c1p / c2q reductions (2 N rows in all)
__host__ __device__ constexpr int const_lanes(int n) {
  int t = 1;
  while (t < 32 && t * 4 * n <= THREADS) t *= 2;
  return t;
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

// TF32 rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero) on
// the bits of a float that is not NaN: add half of the 13 dropped bits,
// clear them. Two integer instructions at full rate. A NaN such as the
// card's own 0x7fffffff would carry into the sign bit and come out as -0;
// the kernel's set-up sees to it that no NaN is lost that way.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small with both rounded to TF32, as the tensor cores take them
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's (N/2) x (N/4) block of a @ b on the tensor cores, 3xTF32:
// acc[mt][nt] is the 16 x 8 tile at rows r0 + 16 mt, columns c0 + 8 nt
// (m16n8k8 accumulator layout). a is row-major with stride lda; b(k, j) is
// b[k * ldb + j] when KMAJOR, else b[j * ldb + k]. Generic pointers: the
// same code reads shared memory or, through L2, device memory. Each k-step
// adds a_small b_big, a_big b_small, then a_big b_big.
template <int N, bool KMAJOR>
__device__ __forceinline__ void warp_product(const float* a, int lda, const float* b, int ldb,
                                             int r0, int c0, float (&acc)[N / 32][N / 32][4]) {
  constexpr int MT = N / 32, NT = N / 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  // k-steps of 8, unrolled in full up to N = 96 and by 2 at N = 128 (registers)
  constexpr int KS = N / 8, KU = N <= 96 ? KS : 2;
#pragma unroll 1
  for (int kc = 0; kc < KS; kc += KU)
#pragma unroll
  for (int ku = 0; ku < KU; ++ku) {
    const int k0 = 8 * (kc + ku);
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ra = a + (r0 + 16 * mt + g) * lda + k0 + t;
      split_tf32(ra[0], ab[mt][0], as[mt][0]);
      split_tf32(ra[8 * lda], ab[mt][1], as[mt][1]);
      split_tf32(ra[4], ab[mt][2], as[mt][2]);
      split_tf32(ra[8 * lda + 4], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = c0 + 8 * nt + g;
      const float y0 = KMAJOR ? b[(k0 + t) * ldb + j] : b[j * ldb + k0 + t];
      const float y1 = KMAJOR ? b[(k0 + t + 4) * ldb + j] : b[j * ldb + k0 + t + 4];
      split_tf32(y0, bb[nt][0], bs[nt][0]);
      split_tf32(y1, bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[mt][nt], as[mt], bb[nt]);
        mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
        mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
      }
  }
}

// out[l] = base[l] - LSE_c(mr[l, c] + vec[c]) over a row (ROWS) or
// out[l] = base[l] - LSE_r(mr[r, l] + vec[r]) over a column of mr.
// TPR lanes share each line; lines >= n are padding and are not written.
// As jax.nn.logsumexp, a non-finite max is replaced by 0 before the shift.
// Returns 1 where this thread wrote a non-finite value.
template <int N, bool ROWS>
__device__ __forceinline__ int lse_update(const float* mr, const float* vec, const float* base,
                                          float* out, int n) {
  constexpr int TPR = lse_tpr(N), LINES = THREADS / TPR, LDA = N + 4, PER = N / TPR;
  const int sub = threadIdx.x % TPR;
  int bad = 0;
#pragma unroll
  for (int l0 = 0; l0 < N; l0 += LINES) {
    const int line = l0 + threadIdx.x / TPR;
    const bool active = line < n;
    float x[PER];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int o = sub + c * TPR;
      x[c] = active ? (ROWS ? mr[line * LDA + o] : mr[o * LDA + line]) + vec[o] : -INFINITY;
      m = fmaxf(m, x[c]);
    }
    for (int s = TPR >> 1; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    const float mm = isfinite(m) ? m : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < PER; ++c) acc += active ? expf(x[c] - mm) : 0.f;
    for (int s = TPR >> 1; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (active && sub == 0) {
      const float r = base[line] - (logf(acc) + mm);
      out[line] = r;
      bad |= !isfinite(r);
    }
  }
  return bad;
}

// this thread's part of sum_j (sum_i exp(mr[i, j] + un[i] + vn[j]) - q[j])^2,
// the column marginal of the would-be plan against q, TPR lanes a column
template <int N>
__device__ __forceinline__ float col_marginal_err2(const float* mr, const float* un, const float* vn,
                                                   const float* q, int n) {
  constexpr int TPR = lse_tpr(N), LINES = THREADS / TPR, LDA = N + 4, PER = N / TPR;
  const int sub = threadIdx.x % TPR;
  float e2 = 0.f;
#pragma unroll
  for (int l0 = 0; l0 < N; l0 += LINES) {
    const int j = l0 + threadIdx.x / TPR;
    const bool active = j < n;
    float col = 0.f;
    if (active) {
      const float vj = vn[j];
#pragma unroll
      for (int c = 0; c < PER; ++c) {
        const int i = sub + c * TPR;
        col += expf(mr[i * LDA + j] + un[i] + vj);
      }
    }
    for (int s = TPR >> 1; s > 0; s >>= 1) col += __shfl_xor_sync(0xffffffffu, col, s);
    if (active && sub == 0) {
      const float dlt = col - q[j];
      e2 += dlt * dlt;
    }
  }
  return e2;
}

// PAD: some solves have n_real < N atoms. Without it n is the constant N and
// every padding test folds away, so full buckets run the unmasked code.
template <int N, bool PAD>
__global__ void __launch_bounds__(THREADS, 1)
    fgw_couplings_kernel(const float* __restrict__ Ms, const float* __restrict__ C1s,
                         const float* __restrict__ C2s, const float* __restrict__ ps,
                         const float* __restrict__ qs, const float* __restrict__ T0s,
                         float* __restrict__ Tout, int* __restrict__ div_out,
                         int* __restrict__ iters_out, int resident, int n_real, float alpha,
                         float epsilon,
                         int pgd_iters, float pgd_tol, int sinkhorn_iters, float sinkhorn_thr) {
  const int n = PAD ? n_real : N;  // atoms of each solve; rows and columns >= n are padding
  constexpr int LDA = N + 4, LDT = N + 8;
  constexpr int MT = N / 32, NT = N / 32;   // a warp's tiles: MT x NT of 16 x 8
  constexpr int V4 = N * N / 4 / THREADS;   // float4 loads per thread per matrix
  constexpr int PE = N * N / THREADS;       // elements per thread, row-major order
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = (warp >> 2) * (N / 2), c0 = (warp & 3) * (N / 4);  // the warp's output block
  const size_t nn = (size_t)N * N;
  float* T = smem;
  float* A = T + N * LDT;  // C1 @ T
  float* mr = A + N * LDA; // -G / eps
  float* p = mr + N * LDA;
  float* logp = p + N;
  float* q = logp + N;
  float* logq = q + N;
  float* c1p = logq + N;
  float* c2q = c1p + N;
  float* u = c2q + N;      // potentials: u, v accepted, un, vn the sweep's, swapped on accept
  float* un = u + N;
  float* v = un + N;
  float* vn = v + N;
  float* red = vn + N;     // 32
  float* mats = red + 32;  // C1, C2 when resident

  const float* C1g = C1s + s * nn;
  const float* C2g = C2s + s * nn;
  // C1 and C2 in shared memory where they fit beside the rest (N <= 96)
  const bool res = smem_floats(N, 1) * sizeof(float) <= MAX_SMEM_BYTES && resident;
  const float* C1 = res ? mats : C1g;
  const float* C2 = res ? mats + N * LDA : C2g;
  const int ldc = res ? LDA : N;

  // set-up: every load issued before the first shared store
  const float* Mg = Ms + s * nn;
  int t0_nan = 0;  // a NaN in T0: every product entry is NaN in f32
  float Mr[MT][NT][4];  // M at this thread's accumulator positions, for the whole solve
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* mp = Mg + (r0 + 16 * mt + g) * N + c0 + 8 * nt + 2 * t;
      const float2 lo = __ldg(reinterpret_cast<const float2*>(mp));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(mp + 8 * N));
      Mr[mt][nt][0] = lo.x, Mr[mt][nt][1] = lo.y, Mr[mt][nt][2] = hi.x, Mr[mt][nt][3] = hi.y;
    }
  {
    const float4* T0v = reinterpret_cast<const float4*>(T0s + s * nn);
    const float4* C1v = reinterpret_cast<const float4*>(C1g);
    const float4* C2v = reinterpret_cast<const float4*>(C2g);
    float4 t0[V4], c1[V4], c2[V4];
#pragma unroll
    for (int r = 0; r < V4; ++r) t0[r] = __ldg(T0v + tid + r * THREADS);
#pragma unroll
    for (int r = 0; r < V4; ++r) {
      if (PAD) {  // the padding of T0 carries no mass
        const int idx = tid + r * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
        if (i >= n || j + 0 >= n) t0[r].x = 0.f;
        if (i >= n || j + 1 >= n) t0[r].y = 0.f;
        if (i >= n || j + 2 >= n) t0[r].z = 0.f;
        if (i >= n || j + 3 >= n) t0[r].w = 0.f;
      }
      t0_nan |= isnan(t0[r].x) | isnan(t0[r].y) | isnan(t0[r].z) | isnan(t0[r].w);
    }
    if (res) {
#pragma unroll
      for (int r = 0; r < V4; ++r) c1[r] = __ldg(C1v + tid + r * THREADS), c2[r] = __ldg(C2v + tid + r * THREADS);
    }
    const float pv = tid < n ? __ldg(ps + (size_t)s * N + tid) : 0.f;
    const float qv = tid < n ? __ldg(qs + (size_t)s * N + tid) : 0.f;
#pragma unroll
    for (int r = 0; r < V4; ++r) {
      const int idx = tid + r * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
      *reinterpret_cast<float4*>(T + i * LDT + j) = t0[r];
      if (res) {
        *reinterpret_cast<float4*>(mats + i * LDA + j) = c1[r];
        *reinterpret_cast<float4*>(mats + N * LDA + i * LDA + j) = c2[r];
      }
    }
    if (tid < N) {
      p[tid] = pv;
      logp[tid] = logf(fmaxf(pv, LOG_EPS));
      q[tid] = qv;
      logq[tid] = logf(fmaxf(qv, LOG_EPS));
    }
  }
  t0_nan = __syncthreads_or(t0_nan);
  // constC[i][j] = c1p[i] + c2q[j]: c1p[i] = sum_k C1[i][k]^2 p[k],
  // c2q[j] = sum_k C2[j][k]^2 q[k]; CL lanes a row over the 2N rows
  {
    constexpr int CL = const_lanes(N), PER = N / CL;
    const int line = tid / CL, sub = tid % CL;
    const bool active = line < 2 * N;
    const bool second = line >= N;
    const float* row = (second ? C2 + (line - N) * ldc : C1 + line * ldc);
    const float* w = second ? q : p;
    float acc = 0.f;
    if (active) {
#pragma unroll 16
      for (int c = 0; c < PER; ++c) {
        const int k = sub + c * CL;
        const float x = row[k];
        acc = fmaf(x * x, w[k], acc);
      }
    }
    for (int o = CL >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (active && sub == 0) {
      if (second) c2q[line - N] = acc;
      else c1p[line] = t0_nan ? __int_as_float(0x7fc00000) : acc;  // all of mr NaN
    }
  }
  __syncthreads();

  bool frozen = false, diverged = false;  // uniform across the block
  int sk_run = 0;                         // Sinkhorn iterations run, all PGD steps
  for (int it = 0; it < pgd_iters; ++it) {
    float acc[MT][NT][4];
    // A = C1 @ T
    warp_product<N, true>(C1, ldc, T, LDT, r0, c0, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* a = A + (r0 + 16 * mt + g) * LDA + c0 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(a) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(a + 8 * LDA) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    if (tid < N) u[tid] = 0.f, v[tid] = 0.f;
    // the padding's potentials stay 0 in both buffers of each pair
    if (PAD && tid < N) un[tid] = 0.f, vn[tid] = 0.f;
    __syncthreads();
    // mr = -(2 alpha (constC - A (2 C2)^T) + (1 - alpha) M) / eps
    warp_product<N, false>(A, LDA, C2, ldc, r0, c0, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int i = r0 + 16 * mt + g, j = c0 + 8 * nt + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = i + 8 * (e >> 1), je = j + (e & 1);
          const float h = 2.f * acc[mt][nt][e];
          const float tens = alpha * (2.f * ((c1p[ie] + c2q[je]) - h)) + (1.f - alpha) * Mr[mt][nt][e];
          mr[ie * LDA + je] = PAD && (ie >= n || je >= n) ? -INFINITY : -tens / epsilon;
        }
      }
    __syncthreads();

    // log-domain Sinkhorn
    bool sfrozen = false, sdiv = false;
    for (int si = 0; si < sinkhorn_iters && !sfrozen; ++si) {
      int bad = lse_update<N, false>(mr, u, logq, vn, n);  // columns
      __syncthreads();
      bad |= lse_update<N, true>(mr, vn, logp, un, n);     // rows
      const bool newly_div = __syncthreads_or(bad) != 0;  // sfrozen is false here
      bool newly_frozen = newly_div;
      if (si % 10 == 0) {
        // column marginal of the would-be plan against q
        const float e2 = block_sum(col_marginal_err2<N>(mr, un, vn, q, n), red);
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

    // candidate plan, its finiteness and its distance to T
    float cand[PE];
    int nonfinite = 0;
    float e2 = 0.f;
#pragma unroll
    for (int r = 0; r < PE; ++r) {
      const int idx = tid + r * THREADS, i = idx / N, j = idx % N;
      cand[r] = expf(mr[i * LDA + j] + u[i] + v[j]);
      nonfinite |= !isfinite(cand[r]);
      const float dlt = cand[r] - T[i * LDT + j];
      e2 += dlt * dlt;
    }
    const bool bad = sdiv || (__syncthreads_or(nonfinite) != 0);
    bool newly_frozen = bad;
    if (it % 10 == 0) {
      e2 = block_sum(e2, red);
      newly_frozen = newly_frozen || sqrtf(e2) <= pgd_tol;
    }
    if (!(frozen || bad)) {
#pragma unroll
      for (int r = 0; r < PE; ++r) {
        const int idx = tid + r * THREADS;
        T[(idx / N) * LDT + idx % N] = cand[r];
      }
    }
    __syncthreads();
    frozen = frozen || newly_frozen;
    diverged = diverged || bad;
  }
#pragma unroll
  for (int r = 0; r < V4; ++r) {
    const int idx = tid + r * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
    reinterpret_cast<float4*>(Tout + s * nn)[idx] = *reinterpret_cast<const float4*>(T + i * LDT + j);
  }
  if (tid == 0) {
    div_out[s] = diverged ? 1 : 0;
    iters_out[s] = sk_run;
  }
}

template <int N, bool PAD>
int launch(const float* Ms, const float* C1s, const float* C2s, const float* ps, const float* qs,
           const float* T0s, float* Tout, int* div_out, int* iters_out, int S, int n, int resident,
           float alpha, float epsilon, int pgd_iters, float pgd_tol, int sinkhorn_iters,
           float sinkhorn_thr, cudaStream_t stream) {
  // the dynamic shared-memory limit is raised once per device and size
  static size_t raised[MAX_DEVICES];
  const size_t smem = smem_floats(N, resident) * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || raised[dev] < smem) {
    err = cudaFuncSetAttribute(fgw_couplings_kernel<N, PAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) raised[dev] = smem;
  }
  fgw_couplings_kernel<N, PAD><<<S, THREADS, smem, stream>>>(
      Ms, C1s, C2s, ps, qs, T0s, Tout, div_out, iters_out, resident, n, alpha, epsilon, pgd_iters,
      pgd_tol, sinkhorn_iters, sinkhorn_thr);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- N = 160 .. 256
// The cluster route, for N above the templates' 128 up to LARGEST_CLUSTER_N
// (256). One solve's T, C1 T and mr do not fit in one SM's shared memory
// above 128 atoms (N = 192: 453 KB), but they fit in a thread-block
// cluster's: each solve runs on a cluster of C = N / R CTAs, and CTA r owns
// row band r, rows rR .. rR + R - 1 (R = 64 at N = 192 and 256, C = 3 and
// 4; R = 32 at N = 160 and 224, C = 5 and 7; fgw_cluster_rows). Its band
// of T (stride N + 8) and one buffer that holds C1's band, then its band of
// C1 T, then of mr (stride N + 4), stay in its shared memory for the whole
// solve; the PR 4 strides keep the fragment reads conflict-free.
// - Product 1, A_band = C1_band T, needs all of T: C1's band is staged in
//   the buffer (cp.async) while the next peer's band of T is copied from
//   that peer's shared memory (distributed shared memory, 16-byte loads)
//   into a local slice buffer; the CTA runs its own band's k-slice first,
//   then each peer's in rank order after its own.
// - Product 2, mr_band from A_band (2 C2)^T, needs all of C2, which every
//   CTA of the cluster reads: it streams through a three-stage ring of
//   k-slices of 16 columns in the slice buffer's room, by cp.async (16-byte
//   copies, one block barrier a k-slice; no TMA). Both products are 3xTF32
//   on the tensor cores with the templates' split and fragment code; a warp
//   owns R/2 x N/4 of the band (2 x 4 warps).
// - Sinkhorn: a row's log-sum-exp is local to its band (one warp a row). A
//   column's is combined across the cluster: each CTA writes its band's
//   (max, sum of exp) for every column, and after a cluster barrier every
//   CTA combines the C partials in rank order 0 .. C - 1, so all hold the
//   same column potentials (a non-finite max is replaced by 0, as
//   jax.nn.logsumexp does, and a band whose sum is 0 adds nothing). The
//   marginal check, the candidate plan's finiteness and its distance to T
//   are band partials summed in rank order after a cluster barrier. Every
//   freeze, rollback and divergence decision is the same in all C CTAs, so
//   control flow stays uniform across the cluster. No atomics: two
//   launches on the same input give the same bits.
// - The candidate plan goes to the slice buffer; when accepted, the slice
//   buffer and T's band swap roles in every CTA of the cluster at once.
//   c2q is computed band by band and gathered from the peers.
// Shared memory a CTA: 2 max(R (N + 8), 3 N (KS + 4)) + R (N + 4) + 9 N +
// 4 R + 48 floats: 161 KB at N = 192 (R = 64), 212 KB at N = 256, one CTA
// an SM; 39 clusters of 3 fit the card at once at N = 192, so S = 90 solves
// take three rounds. What bounds it (clock64 split at N = 192, S = 90,
// scripts/torch_fgw_probe.py, H100 80GB HBM3 at 700 W): the two products,
// 64% of a CTA's cycles, with 8 warps an SM: dropping two of the three
// TF32 mma.sync a product (a timing variant, wrong in its result) took the
// route from 0.69 to 0.53 ms, dropping the splits to 0.63 ms; a ring of 5
// k-slices in flight in place of 2 left product 2 within 1%, and reading
// the peers' T through distributed shared memory in the fragment loads,
// without the copy, made the route 5-7% slower. The Sinkhorn sweeps and
// checks take 15%, the candidate plan 7%, waits at the cluster barriers
// (two a Sinkhorn iteration, two a PGD step) 7%, set-up 6%. wgmma is the
// next step for the products.
// The semantics are the templates': padding left out (mr -inf, potentials
// 0, plan 0), a NaN in T0 poisons all of mr through c1p, freeze, rollback
// and diverged flags, iters_out.

constexpr int LARGEST_CLUSTER_N = 256;  // C = N / 32 <= 8 CTAs: a portable cluster
constexpr int RING_KS = 16;             // C2's k-slice in the ring: two m16n8k8 steps
constexpr int RING_LDS = RING_KS + 4;   // its row stride: conflict-free B fragments
constexpr int RING_STAGES = 3;          // two k-slices in flight

// Shared-memory layout of the cluster route's CTA, in floats.
template <int N, int R>
struct Band {
  static constexpr int C = N / R;                 // CTAs of a cluster, one band each
  static constexpr int LDT = N + 8, LDA = N + 4;  // T's stride, C1 T's and mr's
  static constexpr int MT = R / 32, NT = N / 32;  // a warp's tiles of 16 x 8
  static constexpr int VEC = 9 * N + 4 * R + 48;
  // T's band and the slice buffer (a peer's band of T, C2's ring or the
  // candidate plan) swap on an accepted step, so each takes STAGE floats
  static constexpr int RING = RING_STAGES * N * RING_LDS;
  static constexpr int STAGE = R * LDT > RING ? R * LDT : RING;
  static constexpr size_t FLOATS = 2 * (size_t)STAGE + (size_t)R * LDA + VEC;
  static_assert(FLOATS * sizeof(float) <= MAX_SMEM_BYTES, "the band does not fit");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// acc += a @ b over KSTEPS k-steps of 8 for one warp's MT x NT tiles of
// 16 x 8 at rows r0 + 16 mt, columns c0 + 8 nt; 3xTF32 as warp_product
// (a row-major with stride lda; b(k, j) = b[k * ldb + j] when KMAJOR, else
// b[j * ldb + k]).
template <int MT, int NT, int KSTEPS, bool KMAJOR>
__device__ __forceinline__ void band_mma(const float* a, int lda, const float* b, int ldb, int r0,
                                         int c0, float (&acc)[MT][NT][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ra = a + (r0 + 16 * mt + g) * lda + k0 + t;
      split_tf32(ra[0], ab[mt][0], as[mt][0]);
      split_tf32(ra[8 * lda], ab[mt][1], as[mt][1]);
      split_tf32(ra[4], ab[mt][2], as[mt][2]);
      split_tf32(ra[8 * lda + 4], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = c0 + 8 * nt + g;
      const float y0 = KMAJOR ? b[(k0 + t) * ldb + j] : b[j * ldb + k0 + t];
      const float y1 = KMAJOR ? b[(k0 + t + 4) * ldb + j] : b[j * ldb + k0 + t + 4];
      split_tf32(y0, bb[nt][0], bs[nt][0]);
      split_tf32(y1, bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(acc[mt][nt], as[mt], bb[nt]);
        mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
        mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
      }
  }
}

// The cluster's OR of slot[0] and sum of slot[1] in rank order, on every
// thread: lane r reads CTA r's pair, and the warp walks the ranks in order.
// Each CTA wrote its pair before a cluster barrier.
template <int C>
__device__ __forceinline__ float2 cluster_gather(cooperative_groups::cluster_group& cluster,
                                                 float* slot) {
  const int lane = threadIdx.x & 31;
  float2 mine = make_float2(0.f, 0.f);
  if (lane < C) mine = *reinterpret_cast<const float2*>(cluster.map_shared_rank(slot, lane));
  float flag = 0.f, sum = 0.f;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    flag = fmaxf(flag, __shfl_sync(0xffffffffu, mine.x, r));
    sum += __shfl_sync(0xffffffffu, mine.y, r);
  }
  return make_float2(flag, sum);
}

// un[r] = logp[r] - LSE_j(mr[r, j] + vn[j]) over the band's real rows, one
// warp a row. Returns 1 where this thread wrote a non-finite value.
template <int N, int R>
__device__ __forceinline__ int band_rows_lse(const float* mr, const float* vn, const float* logp,
                                             float* un, int b0, int n) {
  constexpr int LDA = N + 4, PER = N / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bad = 0;
  for (int r = warp; r < R && b0 + r < n; r += THREADS / 32) {
    float x[PER];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      x[c] = mr[r * LDA + lane + 32 * c] + vn[lane + 32 * c];  // -inf on the padding columns
      m = fmaxf(m, x[c]);
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float mm = isfinite(m) ? m : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < PER; ++c) acc += expf(x[c] - mm);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const float out = logp[r] - (logf(acc) + mm);
      un[r] = out;
      bad |= !isfinite(out);
    }
  }
  return bad;
}

template <int N, int R>
__global__ void __launch_bounds__(THREADS, 1)
    fgw_couplings_cluster_kernel(const float* __restrict__ Ms, const float* __restrict__ C1s,
                                 const float* __restrict__ C2s, const float* __restrict__ ps,
                                 const float* __restrict__ qs, const float* __restrict__ T0s,
                                 float* __restrict__ Tout, int* __restrict__ div_out,
                                 int* __restrict__ iters_out, int n, float alpha, float epsilon,
                                 int pgd_iters, float pgd_tol, int sinkhorn_iters,
                                 float sinkhorn_thr) {
  using L = Band<N, R>;
  constexpr int C = L::C, LDT = L::LDT, LDA = L::LDA, MT = L::MT, NT = L::NT;
  constexpr int V4 = R * N / 4 / THREADS;  // float4s of a band per thread
  constexpr int PE = R * N / THREADS;      // band elements per thread, row-major order
  static_assert(N % R == 0 && R % 32 == 0 && N <= THREADS && V4 * 4 * THREADS == R * N, "band shape");
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / C, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * (R / 2), c0 = (warp & 3) * (N / 4);  // the warp's block of the band
  const int b0 = rank * R;                                            // the band's first row
  const size_t nn = (size_t)N * N;
  float* Tb = smem;                 // T's band, R x LDT
  float* stage = Tb + L::STAGE;     // a peer's T band (R x LDT), C2's ring, or the candidate plan
  float* W = stage + L::STAGE;      // C1's band, then C1 T's, then mr's, R x LDA
  float2* cpart = reinterpret_cast<float2*>(W + R * LDA);  // per column: the band's (max, sum)
  float* mpart = reinterpret_cast<float*>(cpart + N);  // per column: the band's marginal
  float* p = mpart + N;
  float* q = p + N;
  float* logq = q + N;
  float* c2q = logq + N;
  float* v = c2q + N;   // column potentials: v accepted, vn the sweep's
  float* vn = v + N;
  float* logp = vn + N;  // the band's rows from here on
  float* c1p = logp + R;
  float* u = c1p + R;   // row potentials: u accepted, un the sweep's
  float* un = u + R;
  float* red = un + R;  // 32
  float* xs = red + 32;  // the Sinkhorn flags a CTA exchanges (and the set-up's NaN flag)
  float* xc = xs + 4;    // the candidate's flag and distance a CTA exchanges
  const float* C1 = C1s + s * nn;
  const float* C2 = C2s + s * nn;
  const float* M = Ms + s * nn;

  // set-up: T's band = T0's without mass on the padding, the marginals
  int t0_nan = 0;  // a NaN in T0: every product entry is NaN in f32
  {
    const float4* src = reinterpret_cast<const float4*>(T0s + s * nn + (size_t)b0 * N);
    float4 x[V4];
#pragma unroll
    for (int r = 0; r < V4; ++r) x[r] = __ldg(src + tid + r * THREADS);
#pragma unroll
    for (int r = 0; r < V4; ++r) {
      const int idx = tid + r * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
      const bool row = b0 + i < n;
      if (!row || j + 0 >= n) x[r].x = 0.f;
      if (!row || j + 1 >= n) x[r].y = 0.f;
      if (!row || j + 2 >= n) x[r].z = 0.f;
      if (!row || j + 3 >= n) x[r].w = 0.f;
      t0_nan |= isnan(x[r].x) | isnan(x[r].y) | isnan(x[r].z) | isnan(x[r].w);
      *reinterpret_cast<float4*>(Tb + i * LDT + j) = x[r];
    }
  }
  for (int j = tid; j < N; j += THREADS) {
    const float pv = j < n ? __ldg(ps + (size_t)s * N + j) : 0.f;
    const float qv = j < n ? __ldg(qs + (size_t)s * N + j) : 0.f;
    p[j] = pv;
    q[j] = qv;
    logq[j] = logf(fmaxf(qv, LOG_EPS));
    if (j >= b0 && j < b0 + R) logp[j - b0] = logf(fmaxf(pv, LOG_EPS));
  }
  t0_nan = __syncthreads_or(t0_nan);
  if (tid == 0) xs[0] = t0_nan ? 1.f : 0.f, xs[1] = 0.f;
  // constC[i][j] = c1p[i] + c2q[j]: the band's rows of C1 and of C2, one
  // warp a row; the other bands' c2q come from their CTAs
  for (int line = warp; line < 2 * R; line += THREADS / 32) {
    const bool second = line >= R;
    const float* row = (second ? C2 + (size_t)(b0 + line - R) * N : C1 + (size_t)(b0 + line) * N);
    const float* w = second ? q : p;
    float x[N / 32];
#pragma unroll
    for (int c = 0; c < N / 32; ++c) x[c] = __ldg(row + lane + 32 * c);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < N / 32; ++c) acc = fmaf(x[c] * x[c], w[lane + 32 * c], acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      if (second) c2q[b0 + line - R] = acc;
      else c1p[line] = acc;
    }
  }
  cluster.sync();  // T's bands, the bands of c2q and the NaN flags, across the cluster
  for (int j = tid; j < N; j += THREADS)
    if (j < b0 || j >= b0 + R) c2q[j] = cluster.map_shared_rank(c2q, j / R)[j];
  if (cluster_gather<C>(cluster, xs).x != 0.f && tid < R) c1p[tid] = __int_as_float(0x7fc00000);

  bool frozen = false, diverged = false;  // uniform across the cluster
  int sk_run = 0;                         // Sinkhorn iterations run, all PGD steps
  for (int it = 0; it < pgd_iters; ++it) {
    if (it > 0) cluster.sync();  // the accepted bands of T, across the cluster
    // product 1: A_band = C1_band @ T, the own band's k-slice first; C1's
    // band is staged in W (cp.async) while the next band of T is copied
    for (int e = tid; e < R * N / 4; e += THREADS) {
      const int i = e / (N / 4), j = 4 * (e % (N / 4));
      cp_async16(W + i * LDA + j, C1 + (size_t)(b0 + i) * N + j);
    }
    cp_async_commit();
    // a peer's band of T into the slice buffer, at most 8 float4s a thread
    // in flight (registers): the first of them before the block barrier
    auto copy_band = [&](int qb) {
      constexpr int PART = V4 > 8 ? V4 / 2 : V4;
      static_assert(V4 % PART == 0, "band copy");
      const float* peer = cluster.map_shared_rank(Tb, qb);
#pragma unroll
      for (int r0 = 0; r0 < V4; r0 += PART) {
        float4 x[PART];
#pragma unroll
        for (int r = 0; r < PART; ++r) {
          const int idx = tid + (r0 + r) * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
          x[r] = *reinterpret_cast<const float4*>(peer + i * LDT + j);
        }
        if (r0 == 0) __syncthreads();  // every warp is done with the slice buffer's last band
#pragma unroll
        for (int r = 0; r < PART; ++r) {
          const int idx = tid + (r0 + r) * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
          *reinterpret_cast<float4*>(stage + i * LDT + j) = x[r];
        }
      }
    };
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll 1
    for (int jq = 0; jq < C; ++jq) {
      const int qb = (rank + jq) % C;
      if (jq != 1) {
        copy_band((qb + (jq == 0)) % C);  // at jq = 0 the next band, ahead of the own
        if (jq == 0) cp_async_wait<0>();
        __syncthreads();
      }
      band_mma<MT, NT, R / 8, true>(W + qb * R, LDA, jq == 0 ? Tb : stage, LDT, r0, c0, acc);
    }
    __syncthreads();  // every warp is done reading C1's band
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* a = W + (r0 + 16 * mt + g) * LDA + c0 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(a) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(a + 8 * LDA) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    // the padding's potentials stay 0 in both buffers of each pair
    for (int j = tid; j < N; j += THREADS) v[j] = 0.f, vn[j] = 0.f;
    if (tid < R) u[tid] = 0.f, un[tid] = 0.f;
    __syncthreads();  // A's band complete; the slice buffer free for the ring
    // product 2: mr_band = -(2 alpha (constC - A_band (2 C2)^T) + (1 - alpha) M) / eps,
    // C2 through the ring, one k-slice of KS columns a stage, STAGES - 1 in flight
    {
      constexpr int KS = RING_KS, LDS = RING_LDS, STAGES = RING_STAGES;
      float* ring = stage;
      auto load = [&](int ks) {
        float* dst = ring + (ks % STAGES) * N * LDS;
        for (int e = tid; e < N * KS / 4; e += THREADS) {
          const int j = e / (KS / 4), h = (e % (KS / 4)) * 4;
          cp_async16(dst + j * LDS + h, C2 + (size_t)j * N + ks * KS + h);
        }
        cp_async_commit();
      };
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
      constexpr int KSLICES = N / KS;
#pragma unroll
      for (int ks = 0; ks < STAGES - 1; ++ks) load(ks);
#pragma unroll 1
      for (int ks = 0; ks < KSLICES; ++ks) {
        if (ks + STAGES - 2 < KSLICES) cp_async_wait<STAGES - 2>();
        else cp_async_wait<0>();
        __syncthreads();  // slice ks landed; every warp is done with slice ks - 1
        if (ks + STAGES - 1 < KSLICES) load(ks + STAGES - 1);  // into slice ks - 1's stage
        band_mma<MT, NT, KS / 8, false>(W + ks * KS, LDA, ring + (ks % STAGES) * N * LDS, LDS, r0,
                                        c0, acc);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int i = r0 + 16 * mt + g, j = c0 + 8 * nt + 2 * t;
        const float2 lo = __ldg(reinterpret_cast<const float2*>(M + (size_t)(b0 + i) * N + j));
        const float2 hi = __ldg(reinterpret_cast<const float2*>(M + (size_t)(b0 + i + 8) * N + j));
        const float mv[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = i + 8 * (e >> 1), je = j + (e & 1);
          const float h = 2.f * acc[mt][nt][e];
          const float tens = alpha * (2.f * ((c1p[ie] + c2q[je]) - h)) + (1.f - alpha) * mv[e];
          acc[mt][nt][e] = b0 + ie >= n || je >= n ? -INFINITY : -tens / epsilon;
        }
      }
    __syncthreads();  // every warp is done reading A's band
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* a = W + (r0 + 16 * mt + g) * LDA + c0 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(a) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(a + 8 * LDA) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();

    // log-domain Sinkhorn
    bool sfrozen = false, sdiv = false;
    for (int si = 0; si < sinkhorn_iters && !sfrozen; ++si) {
      // Sinkhorn columns: the band's (max, sum of exp) of mr[i, j] + u[i],
      // one thread a column, then the cluster's in rank order
      if (tid < n) {
        float m = -INFINITY;
#pragma unroll 8
        for (int r = 0; r < R; ++r) m = fmaxf(m, W[r * LDA + tid] + u[r]);
        const float mm = isfinite(m) ? m : 0.f;
        float sum = 0.f;
#pragma unroll 8
        for (int r = 0; r < R; ++r) sum += expf(W[r * LDA + tid] + u[r] - mm);
        cpart[tid] = make_float2(m, sum);
      }
      cluster.sync();
      int bad = 0;
      if (tid < n) {
        float2 part[C];
        float m = -INFINITY;
#pragma unroll
        for (int r = 0; r < C; ++r) {
          part[r] = cluster.map_shared_rank(cpart, r)[tid];
          m = fmaxf(m, part[r].x);
        }
        const float mm = isfinite(m) ? m : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < C; ++r)
          if (part[r].y != 0.f) sum += part[r].y * expf((isfinite(part[r].x) ? part[r].x : 0.f) - mm);
        const float out = logq[tid] - (logf(sum) + mm);
        vn[tid] = out;
        bad = !isfinite(out);
      }
      __syncthreads();
      // Sinkhorn rows: local to the band
      bad |= band_rows_lse<N, R>(W, vn, logp, un, b0, n);
      // marginal check and flags: the band's column marginals of the
      // would-be plan, then the cluster's flags and marginals
      const bool check = si % 10 == 0;
      if (check) {
        __syncthreads();
        if (tid < n) {
          const float vj = vn[tid];
          float col = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) col += expf(W[r * LDA + tid] + un[r] + vj);
          mpart[tid] = col;
        }
      }
      bad = __syncthreads_or(bad);
      if (tid == 0) xs[0] = bad ? 1.f : 0.f, xs[1] = 0.f;
      cluster.sync();
      const bool newly_div = cluster_gather<C>(cluster, xs).x != 0.f;  // sfrozen is false here
      bool newly_frozen = newly_div;
      if (check) {
        float e2 = 0.f;
        if (tid < n) {
          float col = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) col += cluster.map_shared_rank(mpart, r)[tid];
          const float dlt = col - q[tid];
          e2 = dlt * dlt;
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

    // candidate plan, into the slice buffer: its finiteness and distance to
    // T, band partials summed across the cluster in rank order
    int nonfinite = 0;
    float e2 = 0.f;
#pragma unroll 4
    for (int r = 0; r < PE; ++r) {
      const int idx = tid + r * THREADS, i = idx / N, j = idx % N;
      const float cand = expf(W[i * LDA + j] + u[i] + v[j]);
      nonfinite |= !isfinite(cand);
      const float dlt = cand - Tb[i * LDT + j];
      e2 += dlt * dlt;
      stage[i * LDT + j] = cand;
    }
    nonfinite = __syncthreads_or(nonfinite);
    const bool check = it % 10 == 0;
    if (check) e2 = block_sum(e2, red);
    if (tid == 0) xc[0] = nonfinite ? 1.f : 0.f, xc[1] = check ? e2 : 0.f;
    cluster.sync();
    const float2 got = cluster_gather<C>(cluster, xc);
    const bool bad = sdiv || got.x != 0.f;
    bool newly_frozen = bad;
    if (check) newly_frozen = newly_frozen || sqrtf(got.y) <= pgd_tol;
    if (!(frozen || bad)) {  // the candidate becomes T's band, in every CTA of the cluster
      float* x = Tb;
      Tb = stage, stage = x;
    }
    frozen = frozen || newly_frozen;
    diverged = diverged || bad;
  }
  // store: T's band to Tout
  __syncthreads();
#pragma unroll
  for (int r = 0; r < V4; ++r) {
    const int idx = tid + r * THREADS, i = idx / (N / 4), j = 4 * (idx % (N / 4));
    *reinterpret_cast<float4*>(Tout + s * nn + (size_t)(b0 + i) * N + j) =
        *reinterpret_cast<const float4*>(Tb + i * LDT + j);
  }
  if (rank == 0 && tid == 0) {
    div_out[s] = diverged ? 1 : 0;
    iters_out[s] = sk_run;
  }
  cluster.sync();  // no CTA leaves while a peer may still read its shared memory
}

// The cluster route's instantiations (N, R); fgw_cluster_rows picks R by N.
#define FGW_CLUSTER_SHAPES(X) X(160, 32) X(192, 64) X(224, 32) X(256, 64)

// The launch configuration of <N, R> for S solves, the kernel's shared
// memory limit raised once per device.
template <int N, int R>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int S,
                           cudaStream_t stream) {
  static bool set[MAX_DEVICES];
  const size_t smem = Band<N, R>::FLOATS * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !set[dev]) {
    err = cudaFuncSetAttribute(fgw_couplings_cluster_kernel<N, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) set[dev] = true;
  }
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Band<N, R>::C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(S * Band<N, R>::C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Clusters of <N, R> the device can hold at once (0: none can be placed),
// or minus a CUDA error.
template <int N, int R>
int cluster_active() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<N, R>(cfg, attr, 1, 0);
  int count = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&count, fgw_couplings_cluster_kernel<N, R>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

template <int N, int R>
int launch_cluster(const float* Ms, const float* C1s, const float* C2s, const float* ps,
                   const float* qs, const float* T0s, float* Tout, int* div_out, int* iters_out,
                   int S, int n, float alpha, float epsilon, int pgd_iters, float pgd_tol,
                   int sinkhorn_iters, float sinkhorn_thr, cudaStream_t stream) {
  static int placed[MAX_DEVICES];  // clusters the device holds at once, checked before the first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || placed[dev] <= 0) {
    const int active = cluster_active<N, R>();
    if (active < 0) return -active;
    if (active == 0) return (int)cudaErrorInvalidConfiguration;  // no cluster of C fits
    if (dev < MAX_DEVICES) placed[dev] = active;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = cluster_config<N, R>(cfg, attr, S, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, fgw_couplings_cluster_kernel<N, R>, Ms, C1s, C2s, ps, qs, T0s,
                           Tout, div_out, iters_out, n, alpha, epsilon, pgd_iters, pgd_tol,
                           sinkhorn_iters, sinkhorn_thr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- N = 288 .. 512
// The streamed cluster route, for N above the cluster route's 256 up to
// LARGEST_STREAM_N. The cluster route's band of T and band of mr no longer
// fit a CTA together there (N = 288: a band of 96 rows needs 343 KB, one
// of 32 rows a cluster of 9 CTAs), and the earlier global route (one CTA a
// solve, its fragments loaded from L1/L2; csrc/fgw_team.cu replaced it)
// ran the products at 2.3% of the bound. Here each solve runs on a thread-block cluster of C = N / R <= 8
// CTAs (a portable cluster), CTA r owning rows rR .. rR + R - 1, and only
// mr's band (stride N + 4) stays in shared memory for the whole solve:
// - T lives in the output Tout: set-up copies each
//   band of T0 there, an accepted step writes the band back, and a fence
//   and a cluster barrier make it visible before the peers' next product.
// - The products run one sub-band of SUB rows (32, 48 or 64) at a time:
//   A_sub = C1_sub T into the sub-band's own rows of mr's band, then
//   mr_sub from A_sub (2 C2)^T in registers, written over A_sub once every
//   warp is done reading it. T's and C2's k-slices of KS (32, or 16 where
//   shared memory is short) stream through a ring of 2 or 3 stages by
//   cp.async (16-byte copies, one block barrier a slice; every CTA reads
//   the same T and C2 through L2, no TMA multicast), C1's k-slice of the
//   sub-band riding with T's. 3xTF32 on the tensor cores with the
//   templates' split: a warp owns all SUB rows (MT = SUB / 16 tiles, so
//   each B fragment serves MT mma.sync) and every 8th column tile, and
//   issues a k-step's mma.sync in three passes over its tiles, so that
//   consecutive ones write different accumulators.
// - Sinkhorn and the checks as the cluster route: a row's log-sum-exp is
//   local to the band; a column's combines the bands' (max, sum of exp) in
//   rank order after a cluster barrier; the marginal check, the candidate's
//   finiteness and its distance to T are band partials summed in rank
//   order. No atomics: two launches on one input give the same bits.
// - The candidate plan is not kept (no room): a first pass takes its
//   finiteness and distance to T's band in Tout, an accepted step computes
//   it again into Tout (the same expf on the same operands, the same bits).
// N is a runtime argument and the kernel a template on SUB alone;
// stream_plan picks SUB, KS and the ring's stages for (N, R): the tallest
// sub-band, then the widest slice, that fit shared memory and registers.
// N = 352, 416 and 480 take no band that divides them and the wrapper pads
// them to the next N it takes. What bounds it (clock64 split at N = 288,
// S = 90, R = 96, SUB = 48, KS = 32; scripts/torch_fgw_probe.py, H100 80GB
// HBM3 at 700 W): the two products, 74% of a CTA's cycles (7.1 cycles an
// SM a TF32 mma.sync), then the candidate plan 8%, the Sinkhorn sweeps
// and checks 10%, set-up 5%, the cluster barriers 3%; 39 clusters of 3 fit
// the card at once, so S = 90 solves take three rounds. Bands of 48 rows
// (clusters of 6) run the same S = 90 within 2% and K3's five solves
// 1.9x as fast, so the wrapper takes R = 48 at N = 288 (and at 384, 10%
// faster at S = 90 and 2.2x at S = 5 than R = 96). The first version
// (warps of 16 rows, so each B fragment fed one mma.sync, chained three
// deep on one accumulator, and a separate buffer for A_sub) took 5.62 ms
// at N = 288 against this one's 3.45 and the one-CTA global route's 4.54: B
// fragments shared by MT tiles, independent accumulators in flight and
// wider slices are what made it faster. The semantics
// are the templates': padding left out (mr -inf, potentials 0, plan 0), a
// NaN in T0 poisons all of mr through c1p, freeze, rollback and diverged
// flags, iters_out.

constexpr int LARGEST_STREAM_N = 512;

// The warps of a sub-band of SUB rows: each of the 8 owns all SUB rows
// (MT tiles of 16) and every 8th tile of 8 columns (columns 8 (warp + 8 nt)
// ..), at most NTMAX of them (N <= NMAX): each B fragment serves MT tiles.
template <int SUB>
struct SubBand {
  static constexpr int MT = SUB / 16;
  static constexpr int NMAX = SUB == 64 ? 320 : SUB == 48 ? 384 : LARGEST_STREAM_N;
  static constexpr int NTMAX = (NMAX / 8 + THREADS / 32 - 1) / (THREADS / 32);
};

// the sub-band heights compiled, each with the largest N its registers take
#define FGW_STREAM_SUBS(X) X(32) X(48) X(64)

// sub-band rows, k-slice width and ring stages of the stream route at one
// (N, R); sub = 0 where none fits
struct StreamPlan {
  int sub, ks, stages;
};

// floats of one ring stage: product 1's slice (KS rows of T at stride
// N + 8, then the sub-band's KS columns of C1 at stride KS + 4) or product
// 2's (C2's N rows of KS columns at stride KS + 4)
__host__ __device__ constexpr int stream_stage_floats(int N, int sub, int ks) {
  return ks * (N + 8) + sub * (ks + 4) > N * (ks + 4) ? ks * (N + 8) + sub * (ks + 4) : N * (ks + 4);
}

// shared floats of one CTA: mr's band, the ring, and the vectors (per
// column: the band's (max, sum) and marginal, q, log q, c2q, v, vn; per band
// row: log p, c1p, u, un; 40 for reductions and flags)
__host__ __device__ constexpr size_t stream_floats(int N, int R, int sub, int ks, int stages) {
  return (size_t)R * (N + 4) + (size_t)stages * stream_stage_floats(N, sub, ks) + 8 * (size_t)N +
         4 * (size_t)R + 40;
}

StreamPlan stream_plan(int N, int R) {
  if (N <= LARGEST_CLUSTER_N || N > LARGEST_STREAM_N || N % 32 || R <= 0 || N % R || N / R > 8)
    return {0, 0, 0};
  const StreamPlan tries[] = {{64, 32, 2}, {64, 16, 3}, {64, 16, 2}, {48, 32, 2}, {48, 16, 3},
                              {48, 16, 2}, {32, 32, 2}, {32, 16, 3}, {32, 16, 2}};
  for (const StreamPlan& p : tries) {
    int nmax = 0;
#define FGW_STREAM_NMAX(SB) \
  if (p.sub == SB) nmax = SubBand<SB>::NMAX;
    FGW_STREAM_SUBS(FGW_STREAM_NMAX)
#undef FGW_STREAM_NMAX
    if (R % p.sub || N > nmax) continue;
    if (stream_floats(N, R, p.sub, p.ks, p.stages) * sizeof(float) <= MAX_SMEM_BYTES) return p;
  }
  return {0, 0, 0};
}

// acc[mt][nt] += a @ b over ksteps k-steps of 8 for one warp's tiles of
// SubBand: rows 16 mt .., its first nts tiles of 8 columns, 8 (warp + 8 nt)
// ..; 3xTF32 as warp_product (b(k, j) = b[k * ldb + j] when KMAJOR, else
// b[j * ldb + k]). A k-step loads and splits every fragment first, then
// issues its mma.sync in three passes over the tiles, so that consecutive
// ones write different accumulators; each accumulator still adds a_small
// b_big, a_big b_small, then a_big b_big.
template <int MT, int NTMAX, bool KMAJOR>
__device__ __forceinline__ void sub_mma_step(const float* a, int lda, const float* b, int ldb, int k0,
                                             int nts, float (&acc)[MT][NTMAX][4]) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t ab[MT][4], as[MT][4], bb[NTMAX][2], bs[NTMAX][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* ra = a + (16 * mt + g) * lda + k0 + t;
    split_tf32(ra[0], ab[mt][0], as[mt][0]);
    split_tf32(ra[8 * lda], ab[mt][1], as[mt][1]);
    split_tf32(ra[4], ab[mt][2], as[mt][2]);
    split_tf32(ra[8 * lda + 4], ab[mt][3], as[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < NTMAX; ++nt) {
    if (nt < nts) {
      const int j = 8 * (warp + 8 * nt) + g;
      const float y0 = KMAJOR ? b[(k0 + t) * ldb + j] : b[j * ldb + k0 + t];
      const float y1 = KMAJOR ? b[(k0 + t + 4) * ldb + j] : b[j * ldb + k0 + t + 4];
      split_tf32(y0, bb[nt][0], bs[nt][0]);
      split_tf32(y1, bb[nt][1], bs[nt][1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTMAX; ++nt)
      if (nt < nts) mma_tf32(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTMAX; ++nt)
      if (nt < nts) mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTMAX; ++nt)
      if (nt < nts) mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
}

// acc[mt][nt] += a @ b over ksteps k-steps of 8 for one warp's tiles of
// SubBand: rows 16 mt .., its first nts tiles of 8 columns, 8 (warp + 8 nt)
// ..; 3xTF32 as warp_product (b(k, j) = b[k * ldb + j] when KMAJOR, else
// b[j * ldb + k]). A k-step loads and splits every fragment first, then
// issues its mma.sync in three passes over the tiles, so that consecutive
// ones write different accumulators; each accumulator still adds a_small
// b_big, a_big b_small, then a_big b_big. Two k-steps are unrolled where
// the registers allow (MT <= 3).
template <int MT, int NTMAX, bool KMAJOR>
__device__ __forceinline__ void sub_mma(const float* a, int lda, const float* b, int ldb, int ksteps,
                                        int nts, float (&acc)[MT][NTMAX][4]) {
  if constexpr (MT >= 4) {
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) sub_mma_step<MT, NTMAX, KMAJOR>(a, lda, b, ldb, 8 * ks, nts, acc);
  } else {
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) sub_mma_step<MT, NTMAX, KMAJOR>(a, lda, b, ldb, 8 * ks, nts, acc);
  }
}

// cluster_gather for a cluster of C CTAs known at run time
__device__ __forceinline__ float2 cluster_gather_n(cooperative_groups::cluster_group& cluster,
                                                   float* slot, int C) {
  const int lane = threadIdx.x & 31;
  float2 mine = make_float2(0.f, 0.f);
  if (lane < C) mine = *reinterpret_cast<const float2*>(cluster.map_shared_rank(slot, lane));
  float flag = 0.f, sum = 0.f;
  for (int r = 0; r < C; ++r) {
    flag = fmaxf(flag, __shfl_sync(0xffffffffu, mine.x, r));
    sum += __shfl_sync(0xffffffffu, mine.y, r);
  }
  return make_float2(flag, sum);
}

template <int SUB>
__global__ void __launch_bounds__(THREADS, 1)
    fgw_couplings_stream_kernel(const float* __restrict__ Ms, const float* __restrict__ C1s,
                                const float* __restrict__ C2s, const float* __restrict__ ps,
                                const float* __restrict__ qs, const float* __restrict__ T0s,
                                float* Tout, int* __restrict__ div_out, int* __restrict__ iters_out,
                                int N, int n, int R, int KS, int STAGES, float alpha, float epsilon,
                                int pgd_iters, float pgd_tol, int sinkhorn_iters,
                                float sinkhorn_thr) {
  constexpr int MT = SubBand<SUB>::MT, NTMAX = SubBand<SUB>::NTMAX;
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = N / R;
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / C, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int LDA = N + 4, LDT = N + 8, LDS = KS + 4;
  const int NT = (N / 8 - warp + THREADS / 32 - 1) / (THREADS / 32);  // the warp's column tiles
  const int b0 = rank * R;                                           // the band's first row
  const int STAGE = stream_stage_floats(N, SUB, KS);
  const size_t nn = (size_t)N * N;
  float* mr = smem;              // mr's band, R x LDA: a sub-band of C1 T, then of mr (p during set-up)
  float* ring = mr + R * LDA;    // STAGES slices
  float2* cpart = reinterpret_cast<float2*>(ring + STAGES * STAGE);  // per column: the band's (max, sum)
  float* mpart = reinterpret_cast<float*>(cpart + N);  // per column: the band's marginal
  float* q = mpart + N;
  float* logq = q + N;
  float* c2q = logq + N;
  float* v = c2q + N;    // column potentials: v accepted, vn the sweep's
  float* vn = v + N;
  float* logp = vn + N;  // the band's rows from here on
  float* c1p = logp + R;
  float* u = c1p + R;    // row potentials: u accepted, un the sweep's
  float* un = u + R;
  float* red = un + R;   // 32
  float* xs = red + 32;  // the Sinkhorn flags a CTA exchanges (and the set-up's NaN flag)
  float* xc = xs + 4;    // the candidate's flag and distance a CTA exchanges
  float* p = mr;         // the row marginal, needed by set-up alone
  float* T = Tout + s * nn;  // the plan, in place in the output
  const float* C1 = C1s + s * nn;
  const float* C2 = C2s + s * nn;
  const float* M = Ms + s * nn;

  // set-up: T's band = T0's without mass on the padding, the marginals
  int t0_nan = 0;  // a NaN in T0: every product entry is NaN in f32
  for (int i = warp; i < R; i += THREADS / 32) {
    const bool row = b0 + i < n;
    const float* src = T0s + s * nn + (size_t)(b0 + i) * N;
    float* dst = T + (size_t)(b0 + i) * N;
    for (int j = lane; j < N; j += 32) {
      const float x = row && j < n ? __ldg(src + j) : 0.f;
      t0_nan |= isnan(x);
      dst[j] = x;
    }
  }
  for (int j = tid; j < N; j += THREADS) {
    const float pv = j < n ? __ldg(ps + (size_t)s * N + j) : 0.f;
    const float qv = j < n ? __ldg(qs + (size_t)s * N + j) : 0.f;
    p[j] = pv;
    q[j] = qv;
    logq[j] = logf(fmaxf(qv, LOG_EPS));
    if (j >= b0 && j < b0 + R) logp[j - b0] = logf(fmaxf(pv, LOG_EPS));
  }
  t0_nan = __syncthreads_or(t0_nan);
  if (tid == 0) xs[0] = t0_nan ? 1.f : 0.f, xs[1] = 0.f;
  // constC[i][j] = c1p[i] + c2q[j]: the band's rows of C1 and of C2, one
  // warp a row; the other bands' c2q come from their CTAs
  for (int line = warp; line < 2 * R; line += THREADS / 32) {
    const bool second = line >= R;
    const float* row = second ? C2 + (size_t)(b0 + line - R) * N : C1 + (size_t)(b0 + line) * N;
    const float* w = second ? q : p;
    float acc = 0.f;
    for (int k = lane; k < N; k += 32) {
      const float x = __ldg(row + k);
      acc = fmaf(x * x, w[k], acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      if (second) c2q[b0 + line - R] = acc;
      else c1p[line] = acc;
    }
  }
  __threadfence();  // T's band in Tout, before the peers read it
  cluster.sync();   // T's bands, the bands of c2q and the NaN flags, across the cluster
  for (int j = tid; j < N; j += THREADS)
    if (j < b0 || j >= b0 + R) c2q[j] = cluster.map_shared_rank(c2q, j / R)[j];
  if (cluster_gather_n(cluster, xs, C).x != 0.f)
    for (int i = tid; i < R; i += THREADS) c1p[i] = __int_as_float(0x7fc00000);  // all of mr NaN

  // The ring's slices of one PGD step: slice x is k-slice x % KN of
  // product (x / KN) % 2 for sub-band x / (2 KN).
  const int KN = N / KS, Q = (R / SUB) * 2 * KN;
  const int KSH = KS == 32 ? 3 : 2, KS4 = KS / 4;  // float4s a row of a k-slice: 1 << KSH
  auto load = [&](int x) {
    if (x < Q) {
      float* dst = ring + (x % STAGES) * STAGE;
      const int k0 = (x % KN) * KS;
      if ((x / KN) % 2 == 0) {
        // product 1: T's rows k0 .., then the sub-band's columns k0 .. of C1
        for (int i = warp; i < KS; i += THREADS / 32)
          for (int j = 4 * lane; j < N; j += 128)
            cp_async16(dst + i * LDT + j, T + (size_t)(k0 + i) * N + j);
        float* dc = dst + KS * LDT;
        const float* c1 = C1 + (size_t)(b0 + (x / (2 * KN)) * SUB) * N + k0;
        for (int e = tid; e < SUB * KS4; e += THREADS)
          cp_async16(dc + (e >> KSH) * LDS + 4 * (e & (KS4 - 1)), c1 + (size_t)(e >> KSH) * N + 4 * (e & (KS4 - 1)));
      } else {
        // product 2: C2's columns k0 .. of every row
        for (int e = tid; e < N * KS4; e += THREADS)
          cp_async16(dst + (e >> KSH) * LDS + 4 * (e & (KS4 - 1)),
                     C2 + (size_t)(e >> KSH) * N + k0 + 4 * (e & (KS4 - 1)));
      }
    }
    cp_async_commit();  // empty past the last slice: every slice is one group
  };

  bool frozen = false, diverged = false;  // uniform across the cluster
  int sk_run = 0;                         // Sinkhorn iterations run, all PGD steps
  for (int it = 0; it < pgd_iters; ++it) {
    if (it > 0) cluster.sync();  // the accepted bands of T, across the cluster
    // product 1: A_sub = C1_sub @ T into the sub-band's rows of mr's band;
    // product 2: mr_sub = -(2 alpha (constC - A_sub (2 C2)^T) + (1 - alpha)
    // M_sub) / eps over them, sub-band after sub-band
    float acc[MT][NTMAX][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTMAX; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    for (int x = 0; x < STAGES - 1; ++x) load(x);
#pragma unroll 1
    for (int x = 0; x < Q; ++x) {
      if (STAGES == 3) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();  // slice x landed; every warp is done with slice x - 1
      load(x + STAGES - 1);  // into slice x - 1's stage
      const float* st = ring + (x % STAGES) * STAGE;
      const int kq = x % KN, sb = x / (2 * KN);
      if ((x / KN) % 2 == 0) {
        sub_mma<MT, NTMAX, true>(st + KS * LDT, LDS, st, LDT, KS / 8, NT, acc);
        if (kq == KN - 1) {  // A's sub-band complete, into rows no warp reads now
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NTMAX; ++nt) {
              if (nt < NT) {
                float* a = mr + (sb * SUB + 16 * mt + g) * LDA + 8 * (warp + 8 * nt) + 2 * t;
                *reinterpret_cast<float2*>(a) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
                *reinterpret_cast<float2*>(a + 8 * LDA) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
              }
              acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
            }
        }
      } else {
        sub_mma<MT, NTMAX, false>(mr + sb * SUB * LDA + kq * KS, LDA, st, LDS, KS / 8, NT, acc);
        if (kq == KN - 1) {  // mr's sub-band, over A's once every warp is done reading it
          __syncthreads();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int i = sb * SUB + 16 * mt + g;  // a band row
#pragma unroll
            for (int nt = 0; nt < NTMAX; ++nt) {
              if (nt < NT) {
                const int j = 8 * (warp + 8 * nt) + 2 * t;
                const float2 lo = __ldg(reinterpret_cast<const float2*>(M + (size_t)(b0 + i) * N + j));
                const float2 hi = __ldg(reinterpret_cast<const float2*>(M + (size_t)(b0 + i + 8) * N + j));
                const float mv[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int ie = i + 8 * (e >> 1), je = j + (e & 1);
                  const float h = 2.f * acc[mt][nt][e];
                  const float tens = alpha * (2.f * ((c1p[ie] + c2q[je]) - h)) + (1.f - alpha) * mv[e];
                  mr[ie * LDA + je] = b0 + ie >= n || je >= n ? -INFINITY : -tens / epsilon;
                }
              }
              acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
            }
          }
        }
      }
    }
    // the padding's potentials stay 0 in both buffers of each pair
    for (int j = tid; j < N; j += THREADS) v[j] = 0.f, vn[j] = 0.f;
    for (int i = tid; i < R; i += THREADS) u[i] = 0.f, un[i] = 0.f;
    __syncthreads();

    // log-domain Sinkhorn
    bool sfrozen = false, sdiv = false;
    for (int si = 0; si < sinkhorn_iters && !sfrozen; ++si) {
      // Sinkhorn columns: the band's (max, sum of exp) of mr[i, j] + u[i],
      // one thread a column, then the cluster's in rank order
      for (int j = tid; j < n; j += THREADS) {
        float m = -INFINITY;
        for (int r = 0; r < R; ++r) m = fmaxf(m, mr[r * LDA + j] + u[r]);
        const float mm = isfinite(m) ? m : 0.f;
        float sum = 0.f;
        for (int r = 0; r < R; ++r) sum += expf(mr[r * LDA + j] + u[r] - mm);
        cpart[j] = make_float2(m, sum);
      }
      cluster.sync();
      int bad = 0;
      for (int j = tid; j < n; j += THREADS) {
        float2 part[8];
        float m = -INFINITY;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r < C) {
            part[r] = cluster.map_shared_rank(cpart, r)[j];
            m = fmaxf(m, part[r].x);
          }
        }
        const float mm = isfinite(m) ? m : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r < C && part[r].y != 0.f)
            sum += part[r].y * expf((isfinite(part[r].x) ? part[r].x : 0.f) - mm);
        const float out = logq[j] - (logf(sum) + mm);
        vn[j] = out;
        bad |= !isfinite(out);
      }
      __syncthreads();
      // Sinkhorn rows: local to the band, one warp a row
      for (int r = warp; r < R && b0 + r < n; r += THREADS / 32) {
        const float* row = mr + r * LDA;
        float m = -INFINITY;
        for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j] + vn[j]);  // -inf on the padding
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float mm = isfinite(m) ? m : 0.f;
        float sum = 0.f;
        for (int j = lane; j < N; j += 32) sum += expf(row[j] + vn[j] - mm);
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float out = logp[r] - (logf(sum) + mm);
          un[r] = out;
          bad |= !isfinite(out);
        }
      }
      // marginal check and flags: the band's column marginals of the
      // would-be plan, then the cluster's flags and marginals
      const bool check = si % 10 == 0;
      if (check) {
        __syncthreads();
        for (int j = tid; j < n; j += THREADS) {
          const float vj = vn[j];
          float col = 0.f;
          for (int r = 0; r < R; ++r) col += expf(mr[r * LDA + j] + un[r] + vj);
          mpart[j] = col;
        }
      }
      bad = __syncthreads_or(bad);
      if (tid == 0) xs[0] = bad ? 1.f : 0.f, xs[1] = 0.f;
      cluster.sync();
      const bool newly_div = cluster_gather_n(cluster, xs, C).x != 0.f;  // sfrozen is false here
      bool newly_frozen = newly_div;
      if (check) {
        float e2 = 0.f;
        for (int j = tid; j < n; j += THREADS) {
          float col = 0.f;
          for (int r = 0; r < C; ++r) col += cluster.map_shared_rank(mpart, r)[j];
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

    // candidate plan: its finiteness and distance to T's band, band
    // partials summed across the cluster in rank order
    int nonfinite = 0;
    float e2 = 0.f;
    for (int i = warp; i < R; i += THREADS / 32) {
      const float* Ti = T + (size_t)(b0 + i) * N;
      const float ui = u[i];
      for (int j = lane; j < N; j += 32) {
        const float cand = expf(mr[i * LDA + j] + ui + v[j]);
        nonfinite |= !isfinite(cand);
        const float dlt = cand - Ti[j];
        e2 += dlt * dlt;
      }
    }
    nonfinite = __syncthreads_or(nonfinite);
    const bool check = it % 10 == 0;
    if (check) e2 = block_sum(e2, red);
    if (tid == 0) xc[0] = nonfinite ? 1.f : 0.f, xc[1] = check ? e2 : 0.f;
    cluster.sync();  // also: every peer is done reading T for this step's products
    const float2 got = cluster_gather_n(cluster, xc, C);
    const bool bad = sdiv || got.x != 0.f;
    bool newly_frozen = bad;
    if (check) newly_frozen = newly_frozen || sqrtf(got.y) <= pgd_tol;
    if (!(frozen || bad)) {  // the candidate becomes T's band, in every CTA of the cluster
      for (int i = warp; i < R; i += THREADS / 32) {
        float* Ti = T + (size_t)(b0 + i) * N;
        const float ui = u[i];
        for (int j = lane; j < N; j += 32) Ti[j] = expf(mr[i * LDA + j] + ui + v[j]);
      }
      __threadfence();  // before the next step's barrier: the peers stream this band
    }
    frozen = frozen || newly_frozen;
    diverged = diverged || bad;
  }
  if (rank == 0 && tid == 0) {
    div_out[s] = diverged ? 1 : 0;
    iters_out[s] = sk_run;
  }
  cluster.sync();  // no CTA leaves while a peer may still read its shared memory
}

// The launch configuration of the stream route for S solves at (N, R)
// with SUB-row sub-bands and smem bytes a CTA; the kernel's shared memory
// limit raised once per device.
template <int SUB>
cudaError_t stream_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int S, int N, int R,
                          size_t smem, cudaStream_t stream) {
  static bool set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !set[dev]) {
    err = cudaFuncSetAttribute(fgw_couplings_stream_kernel<SUB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) set[dev] = true;
  }
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = N / R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(S * (N / R)));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Clusters of the stream route at (N, R) the device holds at once (0: none
// can be placed), or minus a CUDA error; cudaErrorInvalidValue where no
// plan fits (N, R).
int stream_active(int N, int R) {
  const StreamPlan plan = stream_plan(N, R);
  if (!plan.sub) return -(int)cudaErrorInvalidValue;
  const size_t smem = stream_floats(N, R, plan.sub, plan.ks, plan.stages) * sizeof(float);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int count = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define FGW_STREAM_ACTIVE(SB)                                                                  \
  if (plan.sub == SB) {                                                                        \
    err = stream_config<SB>(cfg, attr, 1, N, R, smem, 0);                                      \
    if (err == cudaSuccess)                                                                    \
      err = cudaOccupancyMaxActiveClusters(&count, fgw_couplings_stream_kernel<SB>, &cfg);     \
  }
  FGW_STREAM_SUBS(FGW_STREAM_ACTIVE)
#undef FGW_STREAM_ACTIVE
  return err == cudaSuccess ? count : -(int)err;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one solve; resident = 1 keeps C1 and C2 there too.
size_t fgw_smem(int n, int resident) { return smem_floats(n, resident) * sizeof(float); }

// K3. Ms, C1s, C2s, T0s (S,N,N), ps, qs (S,N), f32 contiguous on the device,
// 16-byte aligned, N one of 32, 64, 96, 128, each solve's first n <= N atoms
// real and the rest padding (finite; its mass is taken as 0) -> Tout (S,N,N)
// f32, 0 on the padding, div_out
// (S,) int32 per-solve divergence flags and iters_out (S,) int32, the
// Sinkhorn iterations each solve ran (a frozen solve leaves its Sinkhorn
// loop early). Another N, or n outside [1, N], returns cudaErrorInvalidValue.
int fgw_couplings(const float* Ms, const float* C1s, const float* C2s, const float* ps,
                  const float* qs, const float* T0s, float* Tout, int* div_out, int* iters_out,
                  int S, int N, int n, int resident, float alpha, float epsilon, int pgd_iters,
                  float pgd_tol, int sinkhorn_iters, float sinkhorn_thr, void* stream) {
  if (n < 1 || n > N) return (int)cudaErrorInvalidValue;
  switch (N) {
#define FGW_CASE(NB)                                                                              \
  case NB:                                                                                        \
    return (n < NB ? launch<NB, true> : launch<NB, false>)(                                       \
        Ms, C1s, C2s, ps, qs, T0s, Tout, div_out, iters_out, S, n, resident, alpha, epsilon,      \
        pgd_iters, pgd_tol, sinkhorn_iters, sinkhorn_thr, (cudaStream_t)stream);
    FGW_CASE(32)
    FGW_CASE(64)
    FGW_CASE(96)
    FGW_CASE(128)
#undef FGW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The largest N of the cluster route; above it, the stream route.
int fgw_cluster_limit() { return LARGEST_CLUSTER_N; }

// The band rows R the cluster route takes at N (a cluster of N / R CTAs),
// or 0 where N is not on the cluster route.
int fgw_cluster_rows(int N) {
  switch (N) {
    case 160:
    case 224:
      return 32;
    case 192:
    case 256:
      return 64;
    default:
      return 0;
  }
}

// Dynamic shared-memory bytes of one CTA of the cluster route at (N, R),
// or 0 where (N, R) is not compiled.
size_t fgw_cluster_smem(int N, int R) {
#define FGW_CLUSTER_SMEM(NB, RB) \
  if (N == NB && R == RB) return Band<NB, RB>::FLOATS * sizeof(float);
  FGW_CLUSTER_SHAPES(FGW_CLUSTER_SMEM)
#undef FGW_CLUSTER_SMEM
  return 0;
}

// Clusters of the cluster route at (N, R) that the current device holds at
// once (cudaOccupancyMaxActiveClusters; 0: none fits), or minus a CUDA
// error; cudaErrorInvalidValue where (N, R) is not compiled.
int fgw_cluster_active(int N, int R) {
#define FGW_CLUSTER_ACTIVE(NB, RB) \
  if (N == NB && R == RB) return cluster_active<NB, RB>();
  FGW_CLUSTER_SHAPES(FGW_CLUSTER_ACTIVE)
#undef FGW_CLUSTER_ACTIVE
  return -(int)cudaErrorInvalidValue;
}

// K3's cluster route: arguments as fgw_couplings, plus the band rows R (a
// cluster of N / R CTAs a solve); (N, R) must be one of
// FGW_CLUSTER_SHAPES, else cudaErrorInvalidValue. Before its first launch
// on a device it checks that a cluster can be placed there, and returns
// cudaErrorInvalidConfiguration if none can.
int fgw_couplings_cluster(const float* Ms, const float* C1s, const float* C2s, const float* ps,
                          const float* qs, const float* T0s, float* Tout, int* div_out,
                          int* iters_out, int S, int N, int n, int R, float alpha, float epsilon,
                          int pgd_iters, float pgd_tol, int sinkhorn_iters, float sinkhorn_thr,
                          void* stream) {
  if (n < 1 || n > N) return (int)cudaErrorInvalidValue;
#define FGW_CLUSTER_CASE(NB, RB)                                                                  \
  if (N == NB && R == RB)                                                                         \
    return launch_cluster<NB, RB>(Ms, C1s, C2s, ps, qs, T0s, Tout, div_out, iters_out, S, n,      \
                                  alpha, epsilon, pgd_iters, pgd_tol, sinkhorn_iters,             \
                                  sinkhorn_thr, (cudaStream_t)stream);
  FGW_CLUSTER_SHAPES(FGW_CLUSTER_CASE)
#undef FGW_CLUSTER_CASE
  return (int)cudaErrorInvalidValue;
}

// The largest N of the stream route; above it, the global route.
int fgw_stream_limit() { return LARGEST_STREAM_N; }

// The band rows R the stream route takes at N (a cluster of N / R CTAs), as
// measured on the card (scripts/torch_fgw_probe.py --big), or 0 where N is
// not one of its sizes.
int fgw_stream_rows(int N) {
  switch (N) {
    case 288:
    case 384:
      return 48;
    case 320:
    case 448:
    case 512:
      return 64;
    default:
      return 0;
  }
}

// Dynamic shared-memory bytes of one CTA of the stream route at (N, R), or
// 0 where no plan fits.
size_t fgw_stream_smem(int N, int R) {
  const StreamPlan plan = stream_plan(N, R);
  return plan.sub ? stream_floats(N, R, plan.sub, plan.ks, plan.stages) * sizeof(float) : 0;
}

// The stream route's plan at (N, R) as 10000 SUB + 100 KS + STAGES, or 0.
int fgw_stream_plan(int N, int R) {
  const StreamPlan plan = stream_plan(N, R);
  return 10000 * plan.sub + 100 * plan.ks + plan.stages;
}

// Clusters of the stream route at (N, R) that the current device holds at
// once (cudaOccupancyMaxActiveClusters; 0: none fits), or minus a CUDA
// error; cudaErrorInvalidValue where no plan fits (N, R).
int fgw_stream_active(int N, int R) { return stream_active(N, R); }

// K3's stream route: arguments as fgw_couplings, plus the band rows R (a
// cluster of N / R CTAs a solve); N above 256 up to fgw_stream_limit and R
// with a plan (fgw_stream_smem > 0), else cudaErrorInvalidValue. Tout must
// not alias an input. Before its first launch at (N, R) on a device it
// checks that a cluster can be placed there, and returns
// cudaErrorInvalidConfiguration if none can.
int fgw_couplings_stream(const float* Ms, const float* C1s, const float* C2s, const float* ps,
                         const float* qs, const float* T0s, float* Tout, int* div_out,
                         int* iters_out, int S, int N, int n, int R, float alpha, float epsilon,
                         int pgd_iters, float pgd_tol, int sinkhorn_iters, float sinkhorn_thr,
                         void* stream) {
  const StreamPlan plan = stream_plan(N, R);
  if (!plan.sub || n < 1 || n > N) return (int)cudaErrorInvalidValue;
  // clusters placed, checked before the first launch at (N, C) on a device
  static bool placed[MAX_DEVICES][LARGEST_STREAM_N / 32 + 1][9];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !placed[dev][N / 32][N / R]) {
    const int active = stream_active(N, R);
    if (active < 0) return -active;
    if (active == 0) return (int)cudaErrorInvalidConfiguration;  // no cluster of C fits
    if (dev < MAX_DEVICES) placed[dev][N / 32][N / R] = true;
  }
  const size_t smem = stream_floats(N, R, plan.sub, plan.ks, plan.stages) * sizeof(float);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = cudaErrorInvalidValue;
#define FGW_STREAM_LAUNCH(SB)                                                                       \
  if (plan.sub == SB) {                                                                             \
    err = stream_config<SB>(cfg, attr, S, N, R, smem, (cudaStream_t)stream);                        \
    if (err == cudaSuccess)                                                                         \
      err = cudaLaunchKernelEx(&cfg, fgw_couplings_stream_kernel<SB>, Ms, C1s, C2s, ps, qs, T0s,    \
                               Tout, div_out, iters_out, N, n, R, plan.ks, plan.stages, alpha,      \
                               epsilon, pgd_iters, pgd_tol, sinkhorn_iters, sinkhorn_thr);          \
  }
  FGW_STREAM_SUBS(FGW_STREAM_LAUNCH)
#undef FGW_STREAM_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
