// DIN target attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel recalgorithm_tpu/ops/pallas/din_attention.py
// ::_kernel (pallas_call in _din_attention_core, reached through
// din_attention_fused).  It computes what that kernel computes, per example b
// with query q (H), keys k_t (T x H) and a length len clipped to [0, T]:
//
//   w_t = W3 relu(W2 relu(W1 [q; k_t; q-k_t; q*k_t] + b1) + b2) + b3
//   no softmax: out = sum_{t < len} w_t k_t           (len = 0 -> zeros)
//   softmax:    out = sum_t softmax_t(mask(w)/sqrt(H)) k_t, masked scores
//               NEG_INF = -2^32 + 1, whose weight exp(NEG_INF/sqrt(H) - max)
//               is exactly 0; len = 0 makes every score equal, so the row
//               attends uniformly over all T keys, as the reference does.
//
// It does not copy the TPU layout (batch on the 128 lanes, B padded to a
// multiple of 128): it takes the public layout q (B,H), keys (B,T,H),
// lengths (B,), f32, any B, and torch Linear weights w1 (64,4H), w2 (32,64),
// w3 (1,32) with biases b1 (64), b2 (32), b3 (1).
//
// Bound (H100 SXM: 67 TFLOP/s f32 off the tensor cores, 3.35 TB/s): by
// operations.  With W1 = [W1a | W1b | W1c | W1d] over [q | k | q-k | q*k],
// the least work folds W1d diag(q) into the k block per example, so a valid
// step costs 6,240 FLOP (a 64x16 and a 32x64 product, then 32 + 16) and an
// example 4,096 more; only the n = sum_b min(len_b, T) valid key rows are
// read.  chip_smoke.py's din_attention_bound_ms counts
//   max((6240 n + 4096 B) / 67e12 s, (4 (16 n + 33 B) + 25092) / 3.35e12 s)
// on the lengths it runs (a softmax row with len = 0 reads all T keys and
// does 16 T adds instead): 2.77 us at the serving path's offline batch
// (B=4096, T=50, mean len 6.61, n about 27,100).
//
// Design.  The work per step is two small products against the same
// weights, so the valid steps of a group of examples are packed into row
// tiles and each product runs as a register-blocked f32 SIMT GEMM over a
// tile: one weight read from shared memory serves 8 (layer 1) or 4 (layer
// 2) rows.
//   * A block of 128 threads owns E consecutive examples, E = B / (the
//     blocks the card holds at once), rounded up and clamped to [1, 16], so
//     the grid is one wave; no example is split, so the pooling needs no
//     atomics and the result is deterministic.
//   * Prologue, once a block: w1 and w2 staged through shared memory
//     (coalesced reads, row stride 65), then folded to
//     Wx = [W1b - W1c ; W1d] (32 x 64), acting on x_t = [k_t ; q*k_t], and
//     W2^T (64 x 32); per example wq_e = (W1a + W1c) q_e + b1 (the q term,
//     hoisted).  A warp scan of the E clipped lengths gives each example's
//     offset in the group's packed step list and a table row -> (e, t).
//   * Per chunk of R = 64 packed rows: X (64 x 32) staged from the valid key
//     rows (coalesced float4) and q*k; H1 = relu(X Wx + wq[e(row)]) with an
//     8x4 tile a thread; H2 = relu(H1 W2^T + b2) with a 4x4 tile a thread,
//     whose epilogue takes the score w = H2 w3 + b3 over the 8 lanes that
//     share a row (shuffles) into a per-group score buffer.  Rows past the
//     group's last valid step compute on zeros and are never stored.  Every
//     tile access is a float4, conflict-free or a broadcast within each
//     quarter-warp.  Of the two rates, shared memory's is the tighter: a
//     warp reads one float a thread per wavefront, and a tile of m x n does
//     m n FMA for m + n floats, so 8x4 and 4x4 read 56 wavefronts a row
//     where the FMAs take 32 cycles of the SM's FMA pipes.
//   * Pooling, after the group's chunks: 8 lanes an example, each a float4
//     of the key row and every other step, read its key rows again (from
//     L2), then one shuffle.  Sum: out = sum w_t k_t.  Softmax: an exact
//     two-pass softmax over the stored scores (max, then expf and the
//     weighted sum), scaled by 1/sqrt(H); len = 0 takes the mean of all T
//     keys.
//   Everything is f32 on the CUDA cores: no TF32 (the serving gate is atol
//   1e-5 and the scores go through exp), and products of depth 32 and 64
//   at widths 64 and 32 are too small a tile for wgmma to pay.
//
// Cost of the design: 8.3 kFLOP a packed row (4,096 for layer 1 at depth
// 32, 4,096 for layer 2, about 100 for q*k and the score) against the
// bound's 6,240 a valid step, since W1d diag(q) is per example and cannot
// be shared across a tile; a group's last chunk is padded to 64 rows.  So
// the design's own floor is about 1.3-1.5x the bound.
//
// Measured on an H100 SXM (80 GB HBM3, 700 W power limit; chip_smoke.py
// phases 2, 3 and 5): ptxas 105 registers (sum) and 96 (softmax), no
// spills; 55,056 B of dynamic shared memory a block (Shared), so 4 blocks
// of 128 threads an SM and E = 8 at B=4096.  At the offline batch above,
// 0.0238 ms against the 2.77 us bound (8.6x), where one warp per example
// took 0.0378 ms; at B = 8 to 256 0.010-0.013 ms (was 0.030).  What holds
// it back is latency more than the FMA or shared-memory rate: one block
// alone (B=8) takes 0.010 ms, its prologue's weight loads, each chunk's
// key loads and the pooling's key rows are round trips to L2 in turn, and
// a 64-row chunk reads 3,584 wavefronts of shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int H = 16;       // width of q and of each key
constexpr int A1 = 64;      // f1_att outputs
constexpr int A2 = 32;      // f2_att outputs
constexpr int IN1 = 4 * H;  // f1_att inputs [q; k; q-k; q*k]
constexpr int K1 = 2 * H;   // layer-1 depth after the fold: [k; q*k]
constexpr int T_MAX = 64;   // longest sequence
constexpr int E_MAX = 16;   // examples a block
constexpr int R = 64;       // packed rows a chunk
constexpr int THREADS = 128;
constexpr int WPAD = IN1 + 1;  // row stride of the staged w1/w2 rows: no bank conflicts

static_assert(THREADS * 2 == R * 4, "staging: two float4 of key rows a thread");
static_assert(THREADS == (R / 8) * (A1 / 4), "layer 1: an 8x4 tile a thread");
static_assert(THREADS == (R / 4) * (A2 / 4), "layer 2: a 4x4 tile a thread");
static_assert(THREADS == E_MAX * 8, "pooling: 8 lanes an example");
static_assert(A1 == IN1, "w1 and w2 rows share the staging stride");

struct __align__(16) Shared {
  float wx[K1][A1];       // row k acts on x_k: [W1b - W1c ; W1d], transposed
  float w2t[A1][A2];      // W2^T
  float wq[E_MAX][A1];    // (W1a + W1c) q_e + b1
  float q[E_MAX][H];
  float b2[A2];
  float w3[A2];
  union {
    struct {
      float x[R][K1];     // [k_t ; q*k_t] of the chunk's rows
      float h1[R][A1];
    } tile;
    float w[A1 + A2][WPAD];  // prologue only: the rows of w1, then of w2
  } u;
  float score[E_MAX * T_MAX];  // w_t of packed row off[e] + t
  int row[E_MAX * T_MAX];      // packed row -> (e << 8) | t
  int len[E_MAX];
  int off[E_MAX + 1];          // off[E_MAX]: the group's valid steps
};

static_assert(offsetof(Shared, q) % 16 == 0 && offsetof(Shared, wq) % 16 == 0 &&
              offsetof(Shared, b2) % 16 == 0 && offsetof(Shared, w3) % 16 == 0 &&
              offsetof(Shared, u) % 16 == 0 && sizeof(float) * R * K1 % 16 == 0,
              "float4 access to the shared tiles");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& k) {
  acc.x = fmaf(w, k.x, acc.x);
  acc.y = fmaf(w, k.y, acc.y);
  acc.z = fmaf(w, k.z, acc.z);
  acc.w = fmaf(w, k.w, acc.w);
}

template <bool SOFTMAX>
__global__ void __launch_bounds__(THREADS, 4)
din_attention_kernel(const float* __restrict__ q, const float* __restrict__ keys,
                     const int* __restrict__ lengths,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     float* __restrict__ out, int B, int T, int E) {
  extern __shared__ float4 smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * E;
  const int ne = min(E, B - b0);

  // ---- prologue: weights, the group's queries and lengths
  for (int i = tid; i < A1 * IN1; i += THREADS) s.u.w[i / IN1][i % IN1] = w1[i];
  for (int i = tid; i < A2 * A1; i += THREADS) s.u.w[A1 + i / A1][i % A1] = w2[i];
  for (int i = tid; i < ne * H; i += THREADS) s.q[i / H][i % H] = q[static_cast<size_t>(b0) * H + i];
  if (tid < A2) {
    s.b2[tid] = b2[tid];
    s.w3[tid] = w3[tid];
  }
  if (warp == 0) {
    int len = 0;
    if (lane < ne) {
      len = lengths[b0 + lane];
      len = len < 0 ? 0 : (len > T ? T : len);
    }
    int incl = len;  // inclusive scan; lanes past ne add 0
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < E_MAX) {
      s.len[lane] = len;
      s.off[lane] = incl - len;
    }
    if (lane == 31) s.off[E_MAX] = incl;
  }
  __syncthreads();

  for (int i = tid; i < K1 * A1; i += THREADS) {  // output column c fastest
    const int k = i / A1, c = i % A1;
    s.wx[k][c] = k < H ? s.u.w[c][H + k] - s.u.w[c][2 * H + k] : s.u.w[c][2 * H + k];
  }
  for (int i = tid; i < A1 * A2; i += THREADS) {
    const int k = i / A2, c = i % A2;
    s.w2t[k][c] = s.u.w[A1 + c][k];
  }
  {  // wq: thread -> column c, examples tid / 64, + 2, ...
    const int c = tid % A1;
    float wa[H];
#pragma unroll
    for (int j = 0; j < H; ++j) wa[j] = s.u.w[c][j] + s.u.w[c][2 * H + j];
    const float bc = b1[c];
    for (int e = tid / A1; e < ne; e += THREADS / A1) {
      float a = bc;
#pragma unroll
      for (int j = 0; j < H; ++j) a = fmaf(wa[j], s.q[e][j], a);
      s.wq[e][c] = a;
    }
  }
  for (int i = tid; i < ne * T; i += THREADS) {
    const int e = i / T, t = i - e * T;
    if (t < s.len[e]) s.row[s.off[e] + t] = (e << 8) | t;
  }
  __syncthreads();  // folded weights, wq and the row table ready; u is free

  const int n = s.off[E_MAX];
  const int r1 = 8 * (2 * warp + (lane >> 4)), c1 = 4 * (lane & 15);  // layer-1 tile
  const int r2 = 4 * (4 * warp + (lane >> 3)), c2 = 4 * (lane & 7);   // layer-2 tile
  const float b3r = b3[0];
  const float4* keys4 = reinterpret_cast<const float4*>(keys);

  for (int base = 0; base < n; base += R) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // stage X: thread -> row, quarter of the key
      const int r = (tid >> 2) + half * (THREADS / 4), v = tid & 3, p = base + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), qk = kv;
      if (p < n) {
        const int code = s.row[p], e = code >> 8, t = code & 255;
        kv = keys4[(static_cast<size_t>(b0 + e) * T + t) * (H / 4) + v];
        const float4 qv = ld4(&s.q[e][4 * v]);
        qk = make_float4(qv.x * kv.x, qv.y * kv.y, qv.z * kv.z, qv.w * kv.w);
      }
      *reinterpret_cast<float4*>(&s.u.tile.x[r][4 * v]) = kv;
      *reinterpret_cast<float4*>(&s.u.tile.x[r][H + 4 * v]) = qk;
    }
    __syncthreads();
    {  // layer 1: H1 = relu(X Wx + wq[e(row)]), rows r1..r1+7, columns c1..c1+3
      float4 acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = base + r1 + i;
        acc[i] = ld4(&s.wq[p < n ? s.row[p] >> 8 : 0][c1]);
      }
#pragma unroll
      for (int k = 0; k < K1; k += 4) {
        float4 xa[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xa[i] = ld4(&s.u.tile.x[r1 + i][k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv = ld4(&s.wx[k + kk][c1]);
#pragma unroll
          for (int i = 0; i < 8; ++i) fma4(acc[i], comp(xa[i], kk), wv);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<float4*>(&s.u.tile.h1[r1 + i][c1]) =
            make_float4(fmaxf(acc[i].x, 0.f), fmaxf(acc[i].y, 0.f),
                        fmaxf(acc[i].z, 0.f), fmaxf(acc[i].w, 0.f));
      }
    }
    __syncthreads();
    {  // layer 2 and the score: rows r2..r2+3, columns c2..c2+3
      const float4 ww = ld4(&s.w3[c2]);
      float4 acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = ld4(&s.b2[c2]);
#pragma unroll
      for (int k = 0; k < A1; k += 4) {
        float4 ha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ha[i] = ld4(&s.u.tile.h1[r2 + i][k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv = ld4(&s.w2t[k + kk][c2]);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(acc[i], comp(ha[i], kk), wv);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float w = ww.x * fmaxf(acc[i].x, 0.f);
        w = fmaf(ww.y, fmaxf(acc[i].y, 0.f), w);
        w = fmaf(ww.z, fmaxf(acc[i].z, 0.f), w);
        w = fmaf(ww.w, fmaxf(acc[i].w, 0.f), w);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
        const int p = base + r2 + i;
        if ((lane & 7) == 0 && p < n) s.score[p] = w + b3r;
      }
    }
    // the next chunk's staging writes only x, which no thread reads after
    // the barrier above; its layer 1 writes h1 after the next barrier
  }
  __syncthreads();  // every score stored

  // ---- pooling: 8 lanes an example; lane (j, v) takes float4 v of the key
  // rows t = j, j + 2, ...; the two halves meet in one shuffle
  const int e = tid >> 3, j = (tid >> 2) & 1, v = tid & 3;
  const bool live = e < ne;
  const int len = live ? s.len[e] : 0;
  const float* sc = s.score + (live ? s.off[e] : 0);
  const float4* kp = keys4 + static_cast<size_t>(b0 + (live ? e : 0)) * T * (H / 4) + v;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;  // this lane's share of the softmax normaliser
  if (!SOFTMAX) {
#pragma unroll 4
    for (int t = j; t < len; t += 2) fma4(acc, sc[t], kp[t * (H / 4)]);
  } else if (len == 0) {
    if (live) {
#pragma unroll 4
      for (int t = j; t < T; t += 2) fma4(acc, 1.f, kp[t * (H / 4)]);
    }
  } else {
    const float scale = rsqrtf(static_cast<float>(H));
    float mx = sc[0] * scale;
#pragma unroll 4
    for (int t = 1; t < len; ++t) mx = fmaxf(mx, sc[t] * scale);
#pragma unroll 4
    for (int t = j; t < len; t += 2) {
      const float p = expf(sc[t] * scale - mx);
      l += p;
      fma4(acc, p, kp[t * (H / 4)]);
    }
  }
  // every lane of the warp reaches these shuffles, whatever its branch
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 4);
  acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 4);
  acc.z += __shfl_xor_sync(0xffffffffu, acc.z, 4);
  acc.w += __shfl_xor_sync(0xffffffffu, acc.w, 4);
  const float div = !SOFTMAX ? 1.f : (len == 0 ? static_cast<float>(T) : l);
  if (live && j == 0) {
    reinterpret_cast<float4*>(out)[static_cast<size_t>(b0 + e) * (H / 4) + v] =
        make_float4(acc.x / div, acc.y / div, acc.z / div, acc.w / div);
  }
}

template <bool SOFTMAX>
int launch(const float* q, const float* keys, const int* lengths, const float* w1,
           const float* b1, const float* w2, const float* b2, const float* w3,
           const float* b3, float* out, int B, int T, cudaStream_t st) {
  const int bytes = static_cast<int>(sizeof(Shared));
  cudaError_t err = cudaFuncSetAttribute(din_attention_kernel<SOFTMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_attention_kernel<SOFTMAX>,
                                                      THREADS, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  int per_block = (B + slots - 1) / slots;  // one wave of blocks
  per_block = per_block > E_MAX ? E_MAX : per_block;
  const int blocks = (B + per_block - 1) / per_block;
  din_attention_kernel<SOFTMAX><<<blocks, THREADS, bytes, st>>>(
      q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error of
// the launch (0 when it was accepted).  Pointers are device pointers; keys
// and q must be 16-byte aligned and contiguous, 1 <= T <= 64.
extern "C" int din_attention_forward(const float* q, const float* keys, const int* lengths,
                                     const float* w1, const float* b1, const float* w2,
                                     const float* b2, const float* w3, const float* b3,
                                     float* out, int B, int T, int use_softmax,
                                     void* stream) {
  if (T < 1 || T > T_MAX || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return use_softmax ? launch<true>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T, st)
                     : launch<false>(q, keys, lengths, w1, b1, w2, b2, w3, b3, out, B, T, st);
}
