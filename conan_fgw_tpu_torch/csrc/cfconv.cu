// Fused SchNet continuous-filter convolution (cfconv) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of conan_fgw_tpu/ops/pallas/cfconv.py:
//   K1 cfconv_fwd  <- _fused_fwd_impl / _kernel      (forward messages)
//   K2 cfconv_bwd  <- _fused_bwd_impl / _bwd_kernel  (dx and filter-MLP grads)
//
// Per conformer graph: Gram-form distances, the valid & radius & first-cap-
// by-index neighbour gate with cosine envelope, the Gaussian RBF, the filter
// MLP (Dense -> shifted softplus -> Dense) and m_i = sum_j W_ij gate_ij x_j.
// No (G, N, N, F) tensor ever reaches device memory: the edge pipeline is
// recomputed per tile of ET edges in shared memory and registers.
//
// What bounds it on this card: the filter MLP, 2*(Gs*F + F*F) flops per
// edge, run here on the CUDA cores in f32 (67 TFLOP/s peak) to hold the
// 5e-4 relative contract; the bytes moved (pos, x, weights, messages) are a
// few MB. So it is operation-bound. The design only visits edges whose gate
// is non-zero (compacted per target row), which skips padding atoms and
// out-of-range pairs; tensor cores (TF32 / wgmma) are left for later work.
//
// K1: one block per (target row i, graph g), one thread per filter channel.
// K2: the TPU grid accumulated weight gradients sequentially across graphs;
//     CUDA blocks run concurrently, so each block (a graph and a strided
//     subset of its rows) sums its gradients in shared memory, each thread
//     owning one channel column (no shared-memory atomics), and adds them to
//     the global result with one atomicAdd per element at the end. dx needs
//     the transposed sum over targets i, so it is added atomically too.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ET = 32;       // edges per tile
constexpr int HS = ET + 4;   // padded row stride of the [channel][edge] tiles
constexpr float PI_F = 3.14159265358979323846f;
constexpr float LOG2_F = 0.69314718055994530942f;

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

// Floats of per-graph shared memory: 9 arrays of n plus the count, rounded
// up to a multiple of 4 so the tiles after it stay 16-byte aligned.
__host__ __device__ constexpr int graph_floats(int n) { return (9 * n + 4 + 3) & ~3; }

struct GraphSmem {
  float* pos;   // 3n
  float* sq;    // n
  float* mask;  // n
  float* dist;  // n   distances of the current row
  float* gate;  // n   gate of the current row (0 = no edge)
  int* cand;    // n
  int* list;    // n   compacted source indices of the current row
  int* cnt;     // 4
};

__device__ float* carve_graph(float* smem, int n, GraphSmem& gs) {
  gs.pos = smem;
  gs.sq = gs.pos + 3 * n;
  gs.mask = gs.sq + n;
  gs.dist = gs.mask + n;
  gs.gate = gs.dist + n;
  gs.cand = reinterpret_cast<int*>(gs.gate + n);
  gs.list = gs.cand + n;
  gs.cnt = gs.list + n;
  return smem + graph_floats(n);
}

__device__ void load_graph(const GraphSmem& s, const float* pos, const float* mask, int g, int n) {
  for (int a = threadIdx.x; a < 3 * n; a += blockDim.x) s.pos[a] = pos[(size_t)g * n * 3 + a];
  for (int a = threadIdx.x; a < n; a += blockDim.x) s.mask[a] = mask[(size_t)g * n + a];
  __syncthreads();
  for (int a = threadIdx.x; a < n; a += blockDim.x) s.sq[a] = sqnorm(s.pos + 3 * a);
  __syncthreads();
}

// Neighbour set of target row i: radius graph with torch-cluster's
// first-(cap+1)-candidates-by-index rule (self included, then dropped).
// Fills dist/gate for the row and the compacted list of sources j with a
// non-zero gate.
__device__ void row_edges(const GraphSmem& s, int i, int n, float cutoff, int cap) {
  const bool vi = s.mask[i] > 0.5f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float d = pair_dist(s.pos, s.sq, i, j);
    bool valid = vi && s.mask[j] > 0.5f;
    bool within = valid && d <= cutoff;
    s.dist[j] = d;
    s.cand[j] = (within || (valid && i == j)) ? 1 : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int rank = 0;
    for (int k = 0; k < j; ++k) rank += s.cand[k];
    bool nbr = s.cand[j] && j != i && rank < cap + 1;
    s.gate[j] = nbr ? 0.5f * (cosf(s.dist[j] * PI_F / cutoff) + 1.f) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int j = 0; j < n; ++j)
      if (s.gate[j] != 0.f) s.list[c++] = j;
    *s.cnt = c;
  }
  __syncthreads();
}

// RBF tile, layout [k][ET]; edges past ne are zero so every product stays
// finite.
__device__ void rbf_tile(const GraphSmem& s, float* rbf_s, int e0, int ne, int gs,
                         float step, float coeff) {
  for (int idx = threadIdx.x; idx < gs * ET; idx += blockDim.x) {
    int k = idx / ET, e = idx % ET;
    float v = 0.f;
    if (e < ne) {
      float diff = s.dist[s.list[e0 + e]] - k * step;
      v = expf(coeff * diff * diff);
    }
    rbf_s[k * ET + e] = v;
  }
  __syncthreads();
}

// pre[e] = sum_k rbf[e][k] w1[k][t] + b1[t] for the tile.
__device__ __forceinline__ void filter_layer1(const float* rbf_s, const float* w1, const float* b1,
                                              int gs, int f, int t, float (&pre)[ET]) {
#pragma unroll
  for (int e = 0; e < ET; ++e) pre[e] = 0.f;
  for (int k = 0; k < gs; ++k) {
    float w = __ldg(w1 + k * f + t);
    const float4* r4 = reinterpret_cast<const float4*>(rbf_s + k * ET);
#pragma unroll
    for (int e4 = 0; e4 < ET / 4; ++e4) {
      float4 r = r4[e4];
      pre[4 * e4 + 0] = fmaf(r.x, w, pre[4 * e4 + 0]);
      pre[4 * e4 + 1] = fmaf(r.y, w, pre[4 * e4 + 1]);
      pre[4 * e4 + 2] = fmaf(r.z, w, pre[4 * e4 + 2]);
      pre[4 * e4 + 3] = fmaf(r.w, w, pre[4 * e4 + 3]);
    }
  }
  float bb = __ldg(b1 + t);
#pragma unroll
  for (int e = 0; e < ET; ++e) pre[e] += bb;
}

// out[e] = sum_c tile[c][e] * w[c][t]   (tile layout [channel][HS])
__device__ __forceinline__ void tile_matvec(const float* tile, const float* w, int f, int t,
                                            float (&out)[ET]) {
#pragma unroll
  for (int e = 0; e < ET; ++e) out[e] = 0.f;
  for (int c = 0; c < f; ++c) {
    float wc = __ldg(w + c * f + t);
    const float4* h4 = reinterpret_cast<const float4*>(tile + c * HS);
#pragma unroll
    for (int e4 = 0; e4 < ET / 4; ++e4) {
      float4 h = h4[e4];
      out[4 * e4 + 0] = fmaf(h.x, wc, out[4 * e4 + 0]);
      out[4 * e4 + 1] = fmaf(h.y, wc, out[4 * e4 + 1]);
      out[4 * e4 + 2] = fmaf(h.z, wc, out[4 * e4 + 2]);
      out[4 * e4 + 3] = fmaf(h.w, wc, out[4 * e4 + 3]);
    }
  }
}

__global__ void cfconv_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                                  const float* __restrict__ x, const float* __restrict__ w1,
                                  const float* __restrict__ b1, const float* __restrict__ w2,
                                  const float* __restrict__ b2, float* __restrict__ out, int n,
                                  int f, int gs, float cutoff, int cap) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x, g = blockIdx.y, t = threadIdx.x;
  GraphSmem s;
  float* rest = carve_graph(smem, n, s);
  float* rbf_s = rest;           // gs * ET
  float* h_s = rbf_s + gs * ET;  // f * HS
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);

  load_graph(s, pos, mask, g, n);
  row_edges(s, i, n, cutoff, cap);
  const int cnt = *s.cnt;
  const float* xg = x + (size_t)g * n * f;
  const float bias2 = __ldg(b2 + t);
  float acc = 0.f;
  float a[ET];
  for (int e0 = 0; e0 < cnt; e0 += ET) {
    const int ne = min(ET, cnt - e0);
    rbf_tile(s, rbf_s, e0, ne, gs, step, coeff);
    filter_layer1(rbf_s, w1, b1, gs, f, t, a);
#pragma unroll
    for (int e = 0; e < ET; ++e) h_s[t * HS + e] = ssp(a[e]);
    __syncthreads();
    tile_matvec(h_s, w2, f, t, a);
#pragma unroll
    for (int e = 0; e < ET; ++e) {
      if (e < ne) {
        int j = s.list[e0 + e];
        acc += (a[e] + bias2) * s.gate[j] * xg[(size_t)j * f + t];
      }
    }
    __syncthreads();  // rbf_s / h_s are rewritten by the next tile
  }
  out[((size_t)g * n + i) * f + t] = acc;
}

// One block per (row group r, graph g); the block handles rows i = r, r+R, ...
__global__ void cfconv_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ mask,
                                  const float* __restrict__ x, const float* __restrict__ w1,
                                  const float* __restrict__ b1, const float* __restrict__ w2,
                                  const float* __restrict__ w2t, const float* __restrict__ b2,
                                  const float* __restrict__ gout, float* __restrict__ dx,
                                  float* __restrict__ dw1, float* __restrict__ db1,
                                  float* __restrict__ dw2, float* __restrict__ db2, int n, int f,
                                  int gs, float cutoff, int cap) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x, R = gridDim.x, g = blockIdx.y, t = threadIdx.x;
  GraphSmem s;
  float* rest = carve_graph(smem, n, s);
  float* rbf_s = rest;            // gs * ET
  float* h_s = rbf_s + gs * ET;   // f * HS
  float* dW_s = h_s + f * HS;     // f * HS
  float* dw1_s = dW_s + f * HS;   // gs * f   (column t owned by thread t)
  float* dw2_s = dw1_s + gs * f;  // f * f    (column t owned by thread t)
  const float step = cutoff / (gs - 1);
  const float coeff = -0.5f / (step * step);

  for (int k = 0; k < gs; ++k) dw1_s[k * f + t] = 0.f;
  for (int c = 0; c < f; ++c) dw2_s[c * f + t] = 0.f;
  float db1_acc = 0.f, db2_acc = 0.f;
  load_graph(s, pos, mask, g, n);
  const float* xg = x + (size_t)g * n * f;
  float* dxg = dx + (size_t)g * n * f;
  const float bias2 = __ldg(b2 + t);
  float pre[ET], a[ET], d[ET];

  for (int i = r; i < n; i += R) {
    row_edges(s, i, n, cutoff, cap);
    const int cnt = *s.cnt;
    const float gi = gout[((size_t)g * n + i) * f + t];
    for (int e0 = 0; e0 < cnt; e0 += ET) {
      const int ne = min(ET, cnt - e0);
      rbf_tile(s, rbf_s, e0, ne, gs, step, coeff);
      filter_layer1(rbf_s, w1, b1, gs, f, t, pre);
#pragma unroll
      for (int e = 0; e < ET; ++e) h_s[t * HS + e] = ssp(pre[e]);
      __syncthreads();
      tile_matvec(h_s, w2, f, t, a);  // a[e] = W_e[t] - b2[t]
#pragma unroll
      for (int e = 0; e < ET; ++e) {
        float dW = 0.f;
        if (e < ne) {
          int j = s.list[e0 + e];
          float gate = s.gate[j];
          // out_i = sum_j W_ij gate_ij x_j  ->  dx_j += W_ij gate_ij g_i
          atomicAdd(dxg + (size_t)j * f + t, (a[e] + bias2) * gate * gi);
          dW = gate * gi * xg[(size_t)j * f + t];
        }
        d[e] = dW;
        dW_s[t * HS + e] = dW;
        db2_acc += dW;
      }
      __syncthreads();
      // dw2[c][t] += sum_e h[e][c] dW[e][t]
      for (int c = 0; c < f; ++c) {
        const float4* h4 = reinterpret_cast<const float4*>(h_s + c * HS);
        float acc = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < ET / 4; ++e4) {
          float4 h = h4[e4];
          acc = fmaf(h.x, d[4 * e4 + 0], acc);
          acc = fmaf(h.y, d[4 * e4 + 1], acc);
          acc = fmaf(h.z, d[4 * e4 + 2], acc);
          acc = fmaf(h.w, d[4 * e4 + 3], acc);
        }
        dw2_s[c * f + t] += acc;
      }
      // dh[e][t] = sum_c dW[e][c] w2[t][c] = sum_c dW_s[c][e] w2t[c][t]
      tile_matvec(dW_s, w2t, f, t, a);
#pragma unroll
      for (int e = 0; e < ET; ++e) {
        a[e] *= sigmoidf(pre[e]);  // d softplus(z)/dz = sigmoid(z)
        db1_acc += a[e];
      }
      // dw1[k][t] += sum_e rbf[e][k] dpre[e][t]
      for (int k = 0; k < gs; ++k) {
        const float4* r4 = reinterpret_cast<const float4*>(rbf_s + k * ET);
        float acc = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < ET / 4; ++e4) {
          float4 rv = r4[e4];
          acc = fmaf(rv.x, a[4 * e4 + 0], acc);
          acc = fmaf(rv.y, a[4 * e4 + 1], acc);
          acc = fmaf(rv.z, a[4 * e4 + 2], acc);
          acc = fmaf(rv.w, a[4 * e4 + 3], acc);
        }
        dw1_s[k * f + t] += acc;
      }
      __syncthreads();  // tiles are rewritten by the next tile / row
    }
  }
  for (int k = 0; k < gs; ++k) atomicAdd(dw1 + k * f + t, dw1_s[k * f + t]);
  for (int c = 0; c < f; ++c) atomicAdd(dw2 + c * f + t, dw2_s[c * f + t]);
  atomicAdd(db1 + t, db1_acc);
  atomicAdd(db2 + t, db2_acc);
}

size_t graph_smem_bytes(int n) { return (size_t)graph_floats(n) * sizeof(float); }

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

size_t cfconv_fwd_smem(int n, int f, int gs) {
  return graph_smem_bytes(n) + (size_t)(gs * ET + f * HS) * sizeof(float);
}

size_t cfconv_bwd_smem(int n, int f, int gs) {
  return graph_smem_bytes(n) + (size_t)(gs * ET + 2 * f * HS + gs * f + f * f) * sizeof(float);
}

// K1. pos (G,N,3), mask (G,N) as 0/1 floats, x (G,N,F), w1 (Gs,F), b1 (F),
// w2 (F,F), b2 (F) -> out (G,N,F). All f32, contiguous, on the device.
int cfconv_fwd(const float* pos, const float* mask, const float* x, const float* w1,
               const float* b1, const float* w2, const float* b2, float* out, int G, int N,
               int F, int Gs, float cutoff, int cap, void* stream) {
  size_t smem = cfconv_fwd_smem(N, F, Gs);
  cudaError_t err = cudaFuncSetAttribute(cfconv_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, G);
  cfconv_fwd_kernel<<<grid, F, smem, (cudaStream_t)stream>>>(pos, mask, x, w1, b1, w2, b2, out,
                                                             N, F, Gs, cutoff, cap);
  return (int)cudaGetLastError();
}

// K2. As K1 plus w2t = w2^T and the cotangent gout (G,N,F). Writes dx
// (G,N,F) and the weight gradients summed over all graphs; zeroes them first.
int cfconv_bwd(const float* pos, const float* mask, const float* x, const float* w1,
               const float* b1, const float* w2, const float* w2t, const float* b2,
               const float* gout, float* dx, float* dw1, float* db1, float* dw2, float* db2,
               int G, int N, int F, int Gs, float cutoff, int cap, int row_groups,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaMemsetAsync(dx, 0, (size_t)G * N * F * sizeof(float), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(dw1, 0, (size_t)Gs * F * sizeof(float), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(db1, 0, (size_t)F * sizeof(float), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(dw2, 0, (size_t)F * F * sizeof(float), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(db2, 0, (size_t)F * sizeof(float), st)) != cudaSuccess)
    return (int)err;
  size_t smem = cfconv_bwd_smem(N, F, Gs);
  err = cudaFuncSetAttribute(cfconv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(row_groups, G);
  cfconv_bwd_kernel<<<grid, F, smem, st>>>(pos, mask, x, w1, b1, w2, w2t, b2, gout, dx, dw1, db1,
                                           dw2, db2, N, F, Gs, cutoff, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
