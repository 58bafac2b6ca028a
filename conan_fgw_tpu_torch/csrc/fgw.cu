// Batched entropic-PGD fused Gromov-Wasserstein couplings for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of conan_fgw_tpu/ops/pallas/fgw.py
// (pallas_fgw_couplings_flat -> _super_kernel / _sinkhorn_super).
//
// S independent solves (square loss, symmetric structure, PGD). Each PGD step
//   G  = 2 alpha (constC - C1 T (2 C2)^T) + (1 - alpha) M,
//   mr = -G / eps,
// then log-domain Sinkhorn on mr: per-row and per-column log-sum-exp, each
// stabilised by its own max; the column-marginal check on iterations with
// it % 10 == 0 freezes a converged solve, and non-finite potentials roll
// the solve back and flag it as diverged. After Sinkhorn, a non-finite plan
// also counts as a failure, and the PGD update error (checked on it % 10 == 0)
// freezes the solve. Semantics are those of conan_fgw_tpu/ops/fgw/coupling.py.
//
// What bounds it on this card: a serial chain of small N x N matrix products
// and reductions per solve; the bytes are ~6 N^2 floats per solve and the
// flops 2*2N^3 per PGD step plus ~5 exp per element per Sinkhorn iteration.
// At N=32 neither the memory nor the f32 peak is near: the chain's latency
// bounds it. The design gives each solve one CTA that keeps T, the work
// matrices and the vectors in shared memory for the whole solve (C1, C2 and
// M too where they fit, N <= 96; at N = 128 they are read through L2), so
// no iterate goes back to device memory. constC is the rank-1 sum
// c1p_i + c2q_j, built in the kernel from two vectors. f32 with FMA, no TF32.
// The TPU's lane packing, block-diagonal operands and selector matmuls are
// dropped: they served the TPU layout only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOG_EPS = 1e-30f;

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += red[k];
  return s;
}

// out[r] = base[r] - LSE_c(A[r, c] + vec[c]) over c (rows = true) or
// out[c] = base[c] - LSE_r(A[r, c] + vec[r])     (rows = false).
// `tpr` lanes (a power of two <= 32) share each line. As jax.nn.logsumexp,
// a non-finite max is replaced by 0 before the shift.
__device__ void lse_update(const float* A, int ld, const float* vec, const float* base, float* out,
                           int n, int tpr, bool rows) {
  const int lines = blockDim.x / tpr;
  const int sub = threadIdx.x % tpr;
  for (int l0 = 0; l0 < n; l0 += lines) {
    const int line = l0 + threadIdx.x / tpr;
    const bool active = (threadIdx.x / tpr) < lines && line < n;
    float m = -INFINITY;
    if (active) {
      for (int o = sub; o < n; o += tpr) {
        float x = rows ? A[line * ld + o] + vec[o] : A[o * ld + line] + vec[o];
        m = fmaxf(m, x);
      }
    }
    for (int s = tpr >> 1; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    const float mm = isfinite(m) ? m : 0.f;
    float acc = 0.f;
    if (active) {
      for (int o = sub; o < n; o += tpr) {
        float x = rows ? A[line * ld + o] + vec[o] : A[o * ld + line] + vec[o];
        acc += expf(x - mm);
      }
    }
    for (int s = tpr >> 1; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (active && sub == 0) out[line] = base[line] - (logf(acc) + mm);
  }
}

__global__ void fgw_couplings_kernel(const float* __restrict__ Ms, const float* __restrict__ C1s,
                                     const float* __restrict__ C2s, const float* __restrict__ ps,
                                     const float* __restrict__ qs, const float* __restrict__ T0s,
                                     float* __restrict__ Tout, int* __restrict__ div_out,
                                     int* __restrict__ iters_out, int n,
                                     int resident, float alpha, float epsilon, int pgd_iters,
                                     float pgd_tol, int sinkhorn_iters, float sinkhorn_thr) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int ld = n + 1;  // padded stride: row and column walks are conflict-free
  const size_t nn = (size_t)n * n;
  float* T = smem;
  float* A = T + n * ld;   // C1 @ T, then the candidate plan
  float* B = A + n * ld;   // mr = -G / eps
  float* vecs = B + n * ld;
  float* logp = vecs;
  float* logq = logp + n;
  float* q = logq + n;
  float* c1p = q + n;
  float* c2q = c1p + n;
  float* u = c2q + n;
  float* v = u + n;
  float* un = v + n;
  float* vn = un + n;
  float* red = vn + n;  // 32
  float* mats = red + 32;

  const float* Mg = Ms + s * nn;
  const float* C1g = C1s + s * nn;
  const float* C2g = C2s + s * nn;
  const float *M, *C1, *C2;
  int ldi;
  if (resident) {
    float* Ms_ = mats;
    float* C1_ = Ms_ + n * ld;
    float* C2_ = C1_ + n * ld;
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      int i = idx / n, j = idx % n;
      Ms_[i * ld + j] = Mg[idx];
      C1_[i * ld + j] = C1g[idx];
      C2_[i * ld + j] = C2g[idx];
    }
    M = Ms_, C1 = C1_, C2 = C2_, ldi = ld;
  } else {
    M = Mg, C1 = C1g, C2 = C2g, ldi = n;
  }
  for (int idx = tid; idx < n * n; idx += blockDim.x) T[(idx / n) * ld + idx % n] = T0s[s * nn + idx];
  for (int i = tid; i < n; i += blockDim.x) {
    logp[i] = logf(fmaxf(ps[(size_t)s * n + i], LOG_EPS));
    q[i] = qs[(size_t)s * n + i];
    logq[i] = logf(fmaxf(q[i], LOG_EPS));
  }
  __syncthreads();
  // constC[i][j] = sum_k C1[i][k]^2 p[k] + sum_k C2[j][k]^2 q[k]
  for (int i = tid; i < n; i += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < n; ++k) {
      float c1 = C1[i * ldi + k], c2 = C2[i * ldi + k];
      a = fmaf(c1 * c1, ps[(size_t)s * n + k], a);
      b = fmaf(c2 * c2, q[k], b);
    }
    c1p[i] = a;
    c2q[i] = b;
  }
  __syncthreads();

  int tpr = 1;
  while (tpr < 32 && tpr * 2 * n <= (int)blockDim.x) tpr *= 2;

  bool frozen = false, diverged = false;  // uniform across the block
  int sk_run = 0;                         // Sinkhorn iterations run, all PGD steps
  for (int it = 0; it < pgd_iters; ++it) {
    // A = C1 @ T
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      int i = idx / n, j = idx % n;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(C1[i * ldi + k], T[k * ld + j], acc);
      A[i * ld + j] = acc;
    }
    __syncthreads();
    // B = -(2 alpha (constC - A (2 C2)^T) + (1 - alpha) M) / eps
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      int i = idx / n, j = idx % n;
      float h = 0.f;
      for (int k = 0; k < n; ++k) h = fmaf(A[i * ld + k], C2[j * ldi + k], h);
      h *= 2.f;
      float tens = alpha * (2.f * ((c1p[i] + c2q[j]) - h)) + (1.f - alpha) * M[i * ldi + j];
      B[i * ld + j] = -tens / epsilon;
    }
    for (int i = tid; i < n; i += blockDim.x) u[i] = 0.f, v[i] = 0.f;
    __syncthreads();

    // log-domain Sinkhorn
    bool sfrozen = false, sdiv = false;
    for (int si = 0; si < sinkhorn_iters && !sfrozen; ++si) {
      lse_update(B, ld, u, logq, vn, n, tpr, false);  // columns
      __syncthreads();
      lse_update(B, ld, vn, logp, un, n, tpr, true);  // rows
      __syncthreads();
      int bad_local = 0;
      for (int i = tid; i < n; i += blockDim.x) bad_local |= !isfinite(un[i]) || !isfinite(vn[i]);
      const bool newly_div = __syncthreads_or(bad_local) != 0;  // sfrozen is false here
      bool newly_frozen = newly_div;
      if (si % 10 == 0) {
        // column marginal of the would-be plan against q
        float e2 = 0.f;
        for (int j = tid; j < n; j += blockDim.x) {
          float col = 0.f;
          for (int i = 0; i < n; ++i) col += expf(B[i * ld + j] + un[i] + vn[j]);
          float dlt = col - q[j];
          e2 += dlt * dlt;
        }
        e2 = block_sum(e2, red);
        newly_frozen = newly_frozen || sqrtf(e2) < sinkhorn_thr;
      }
      if (!newly_div) {
        for (int i = tid; i < n; i += blockDim.x) u[i] = un[i], v[i] = vn[i];
      }
      __syncthreads();
      sfrozen = newly_frozen;
      sdiv = sdiv || newly_div;
      ++sk_run;
    }

    // candidate plan, its finiteness and its distance to T
    int nonfinite = 0;
    float e2 = 0.f;
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      int i = idx / n, j = idx % n;
      float tn = expf(B[i * ld + j] + u[i] + v[j]);
      A[i * ld + j] = tn;
      nonfinite |= !isfinite(tn);
      float dlt = tn - T[i * ld + j];
      e2 += dlt * dlt;
    }
    const bool bad = sdiv || (__syncthreads_or(nonfinite) != 0);
    bool newly_frozen = bad;
    if (it % 10 == 0) {
      e2 = block_sum(e2, red);
      newly_frozen = newly_frozen || sqrtf(e2) <= pgd_tol;
    }
    if (!(frozen || bad)) {
      for (int idx = tid; idx < n * n; idx += blockDim.x) {
        int i = idx / n, j = idx % n;
        T[i * ld + j] = A[i * ld + j];
      }
    }
    __syncthreads();
    frozen = frozen || newly_frozen;
    diverged = diverged || bad;
  }
  for (int idx = tid; idx < n * n; idx += blockDim.x) Tout[s * nn + idx] = T[(idx / n) * ld + idx % n];
  if (tid == 0) {
    div_out[s] = diverged ? 1 : 0;
    iters_out[s] = sk_run;
  }
}

size_t smem_floats(int n, int resident) {
  return (size_t)(3 + 3 * resident) * n * (n + 1) + 9 * n + 32;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one solve; resident = 1 keeps M, C1 and C2 there too.
size_t fgw_smem(int n, int resident) { return smem_floats(n, resident) * sizeof(float); }

// K3. Ms, C1s, C2s, T0s (S,N,N), ps, qs (S,N), f32 contiguous on the device
// -> Tout (S,N,N) f32, div_out (S,) int32 per-solve divergence flags and
// iters_out (S,) int32, the Sinkhorn iterations each solve ran (a frozen solve
// leaves its Sinkhorn loop early).
int fgw_couplings(const float* Ms, const float* C1s, const float* C2s, const float* ps,
                  const float* qs, const float* T0s, float* Tout, int* div_out, int* iters_out,
                  int S, int N, int resident, float alpha, float epsilon, int pgd_iters,
                  float pgd_tol, int sinkhorn_iters, float sinkhorn_thr, void* stream) {
  size_t smem = fgw_smem(N, resident);
  cudaError_t err = cudaFuncSetAttribute(fgw_couplings_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fgw_couplings_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      Ms, C1s, C2s, ps, qs, T0s, Tout, div_out, iters_out, N, resident, alpha, epsilon, pgd_iters,
      pgd_tol, sinkhorn_iters, sinkhorn_thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
