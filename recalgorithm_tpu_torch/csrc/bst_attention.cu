// BST masked multi-head attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernel bodies of
// recalgorithm_tpu/ops/pallas/bst_attention.py:
//   * _fwd_kernel (pallas_call in _bst_mha_core and _bst_mha_core_t): the
//     inference forward, probabilities kept on chip;
//   * _fwd_kernel_save_attn (pallas_call in _mha_fwd and _mha_t_fwd): the
//     training forward, which also writes the probabilities P, in f32 or bf16;
//   * _bwd_kernel (pallas_call in _mha_bwd and _mha_t_bwd): the analytic
//     backward from the saved P.
// Per (b, h), with q, k, v of (T, d), the key mask j < len and s = 1/sqrt(d):
//
//   P  = softmax_j(mask(q k^T s)),  o = P v
//   dv = P^T do;  dp = do v^T;  dl = P o (dp - rowsum(dp o P)) s, zero at j >= len
//   dq = dl k;    dk = dl^T q
//
// It computes what mha_reference (the plain JAX path, and the port's twin)
// computes, masked scores NEG_INF = -2^32 + 1: a row with len = 0 attends
// uniformly over all T keys (every score is NEG_INF) and, as the reference's
// autograd gives, passes no gradient to q or k; lengths above T clip to T.
// (The Pallas backward forms dl unmasked and so differs from the reference on
// len = 0 rows; no model path feeds len = 0.)
//
// It does not copy the TPU layout ((H, T*d, B), batch on the 128 lanes,
// B padded to a multiple of 128): it takes the public layout q, k, v, o of
// (B, H, T, d), f32, contiguous, lengths (B,) int32, P (B, H, T, T), any B.
//
// Design (simple first): one block of 64 threads per (b, h).
//   * Forward: K and V (T x 16 floats each) are staged into shared memory with
//     float4 copies; thread i owns query row i, keeps it in registers and
//     makes three passes over the valid keys (row max, normaliser, then
//     p_ij = exp(s_ij - m) / l and o_i += p_ij v_j), recomputing the 16-wide
//     dot product each pass rather than keeping a 64-entry score row in
//     registers.  When P is asked for, rows go through a shared (T, T+1) tile
//     so the write to device memory is coalesced.
//   * Backward: q, k, v, do and P are staged (P with row pitch T_MAX + 1, so
//     both row and column walks are free of bank conflicts).  A column pass
//     (thread j) gives dv_j = sum_i P_ij do_i; a row pass (thread i) gives the
//     row sum D_i, overwrites row i of the tile with dl_i and gives dq_i; a
//     second column pass gives dk_j = sum_i dl_ij q_i.  No atomics: every
//     output row has one owner thread.
//
// Bound (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32 off the tensor cores).  Per
// (b, h) with n = min(len, T) valid keys, the forward does 4 T n d FLOP
// (scores, P v) and the backward 8 T n d (P^T do, dp, dl k, dl^T q); a len = 0
// row does 2 T^2 d instead (the uniform mean of v, and P^T do).  Bytes, only
// what the function needs (+ 4 B of lengths per b):
//   forward  4 (2 T d + 2 n d)        (q in, o out; the n valid rows of k, v;
//                                      a len = 0 row: all T rows of v, no k)
//   + P      + 4 T^2 (f32) or 2 T^2 (bf16), written in full
//   backward 4 (5 T d + 2 n d) + 4 T n (f32 P) or 2 T n (bf16 P)
//                                     (q, do in, dq, dk, dv out; the n valid
//                                      rows of k, v and columns of P; a len = 0
//                                      row needs none: its dl is 0, P is 1/T)
// With every key valid (n = T = 51) at B=4096, H=3, d=16 that is 160, 288 and
// 409 MB, all bound by bytes; the train path's shorter histories need far
// less.  chip_smoke.py computes the bound from each run's lengths.  No tensor
// cores: d = 16 and T <= 64 give products too thin for wgmma at one (b, h) a
// block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 16;            // head width
constexpr int T_MAX = 64;        // longest sequence; one thread per row
constexpr int THREADS = T_MAX;
constexpr int PP = T_MAX + 1;    // row pitch of the staged T x T tile
constexpr float SCALE = 0.25f;   // 1 / sqrt(D), exact
constexpr float NEG_INF = -4294967295.0f;  // -(2^32) + 1, the reference's mask

__device__ __forceinline__ int clip_len(int len, int t) {
  return len < 0 ? 0 : (len > t ? t : len);
}

__device__ __forceinline__ float dot(const float (&a)[D], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < D / 4; ++v) {
    const float4 x = r4[v];
    s = fmaf(a[4 * v], x.x, s);
    s = fmaf(a[4 * v + 1], x.y, s);
    s = fmaf(a[4 * v + 2], x.z, s);
    s = fmaf(a[4 * v + 3], x.w, s);
  }
  return s;
}

__device__ __forceinline__ void axpy(float (&acc)[D], float p, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int v = 0; v < D / 4; ++v) {
    const float4 x = r4[v];
    acc[4 * v] = fmaf(p, x.x, acc[4 * v]);
    acc[4 * v + 1] = fmaf(p, x.y, acc[4 * v + 1]);
    acc[4 * v + 2] = fmaf(p, x.z, acc[4 * v + 2]);
    acc[4 * v + 3] = fmaf(p, x.w, acc[4 * v + 3]);
  }
}

__device__ __forceinline__ void load_row(float (&a)[D], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int v = 0; v < D / 4; ++v) {
    const float4 x = r4[v];
    a[4 * v] = x.x;
    a[4 * v + 1] = x.y;
    a[4 * v + 2] = x.z;
    a[4 * v + 3] = x.w;
  }
}

__device__ __forceinline__ void store_row(float* row, const float (&a)[D]) {
  float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int v = 0; v < D / 4; ++v) {
    r4[v] = make_float4(a[4 * v], a[4 * v + 1], a[4 * v + 2], a[4 * v + 3]);
  }
}

// rows x D floats, row-major, global -> shared, float4 copies
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int rows) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int x = threadIdx.x; x < rows * (D / 4); x += blockDim.x) d4[x] = s4[x];
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <bool SAVE, typename PT>
__global__ void __launch_bounds__(THREADS)
bst_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ lengths,
                         float* __restrict__ out, PT* __restrict__ probs, int H, int T) {
  __shared__ __align__(16) float ks[T_MAX * D];
  __shared__ __align__(16) float vs[T_MAX * D];
  __shared__ float ps[SAVE ? T_MAX * PP : 1];
  const int bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const int len = clip_len(lengths[bh / H], T);
  const int i = threadIdx.x;
  stage(ks, k + base, T);
  stage(vs, v + base, T);
  __syncthreads();

  if (i < T) {
    float acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    if (len == 0) {  // every score is NEG_INF: uniform over all T keys
      const float p = 1.0f / static_cast<float>(T);
      for (int j = 0; j < T; ++j) {
        axpy(acc, p, vs + j * D);
        if (SAVE) ps[i * PP + j] = p;
      }
    } else {
      float qi[D];
      load_row(qi, q + base + i * D);
      float m = NEG_INF;
      for (int j = 0; j < len; ++j) m = fmaxf(m, dot(qi, ks + j * D) * SCALE);
      float l = 0.f;
      for (int j = 0; j < len; ++j) l += expf(dot(qi, ks + j * D) * SCALE - m);
      for (int j = 0; j < len; ++j) {
        const float p = expf(dot(qi, ks + j * D) * SCALE - m) / l;
        axpy(acc, p, vs + j * D);
        if (SAVE) ps[i * PP + j] = p;
      }
      if (SAVE) {  // masked keys: exp(NEG_INF - m) is exactly 0
        for (int j = len; j < T; ++j) ps[i * PP + j] = 0.f;
      }
    }
    store_row(out + base + i * D, acc);
  }
  if (SAVE) {
    __syncthreads();
    PT* dst = probs + static_cast<size_t>(bh) * T * T;
    for (int x = threadIdx.x; x < T * T; x += blockDim.x) {
      put(dst + x, ps[(x / T) * PP + x % T]);
    }
  }
}

template <typename PT>
__global__ void __launch_bounds__(THREADS)
bst_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const PT* __restrict__ probs,
                         const float* __restrict__ dout, const int* __restrict__ lengths,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int T) {
  __shared__ __align__(16) float qs[T_MAX * D];
  __shared__ __align__(16) float ks[T_MAX * D];
  __shared__ __align__(16) float vs[T_MAX * D];
  __shared__ __align__(16) float dos[T_MAX * D];
  __shared__ float ps[T_MAX * PP];  // P, then dl row by row
  const int bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const int len = clip_len(lengths[bh / H], T);
  const int t = threadIdx.x;
  stage(qs, q + base, T);
  stage(ks, k + base, T);
  stage(vs, v + base, T);
  stage(dos, dout + base, T);
  const PT* src = probs + static_cast<size_t>(bh) * T * T;
  for (int x = threadIdx.x; x < T * T; x += blockDim.x) {
    ps[(x / T) * PP + x % T] = get(src + x);
  }
  __syncthreads();

  float acc[D];
  if (t < T) {  // column pass: dv_t = sum_i P_it do_i
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    for (int i = 0; i < T; ++i) axpy(acc, ps[i * PP + t], dos + i * D);
    store_row(dv + base + t * D, acc);
  }
  __syncthreads();  // the row pass overwrites P with dl

  if (t < T) {  // row pass: dl_t. and dq_t = sum_j dl_tj k_j
    float doi[D];
    load_row(doi, dos + t * D);
    float rowsum = 0.f;
    for (int j = 0; j < len; ++j) rowsum = fmaf(ps[t * PP + j], dot(doi, vs + j * D), rowsum);
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    for (int j = 0; j < len; ++j) {
      const float dl = ps[t * PP + j] * (dot(doi, vs + j * D) - rowsum) * SCALE;
      ps[t * PP + j] = dl;
      axpy(acc, dl, ks + j * D);
    }
    for (int j = len; j < T; ++j) ps[t * PP + j] = 0.f;  // masked keys pass nothing
    store_row(dq + base + t * D, acc);
  }
  __syncthreads();

  if (t < T) {  // column pass: dk_t = sum_i dl_it q_i
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    if (t < len) {
      for (int i = 0; i < T; ++i) axpy(acc, ps[i * PP + t], qs + i * D);
    }
    store_row(dk + base + t * D, acc);
  }
}

bool bad_shape(int B, int H, int T) {
  return B < 0 || H < 1 || T < 1 || T > T_MAX ||
         static_cast<long long>(B) * H > 2147483647LL;
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when the launch was accepted.  Pointers are device
// pointers to contiguous tensors; q, k, v, out, dout, dq, dk, dv 16-byte
// aligned; d = 16 and 1 <= T <= 64.
//
// save: 0 = no P (inference), 1 = P in f32, 2 = P in bf16.
extern "C" int bst_attention_forward(const float* q, const float* k, const float* v,
                                     const int* lengths, float* out, void* probs,
                                     int B, int H, int T, int save, void* stream) {
  if (bad_shape(B, H, T) || save < 0 || save > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (save == 0) {
    bst_attention_fwd_kernel<false, float><<<blocks, THREADS, 0, st>>>(
        q, k, v, lengths, out, nullptr, H, T);
  } else if (save == 1) {
    bst_attention_fwd_kernel<true, float><<<blocks, THREADS, 0, st>>>(
        q, k, v, lengths, out, static_cast<float*>(probs), H, T);
  } else {
    bst_attention_fwd_kernel<true, __nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        q, k, v, lengths, out, static_cast<__nv_bfloat16*>(probs), H, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// probs_bf16: 0 = P is f32, 1 = P is bf16.
extern "C" int bst_attention_backward(const float* q, const float* k, const float* v,
                                      const void* probs, const float* dout,
                                      const int* lengths, float* dq, float* dk,
                                      float* dv, int B, int H, int T, int probs_bf16,
                                      void* stream) {
  if (bad_shape(B, H, T)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (probs_bf16) {
    bst_attention_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        q, k, v, static_cast<const __nv_bfloat16*>(probs), dout, lengths, dq, dk, dv, H, T);
  } else {
    bst_attention_bwd_kernel<float><<<blocks, THREADS, 0, st>>>(
        q, k, v, static_cast<const float*>(probs), dout, lengths, dq, dk, dv, H, T);
  }
  return static_cast<int>(cudaGetLastError());
}
