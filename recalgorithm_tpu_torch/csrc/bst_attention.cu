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
// Design.
//   * Forward: bound by bytes, and on the train path most keys are masked
//     (mean n 7.6 of T = 51).  One warp per (b, h), FWD_WARPS = 4 pairs a
//     block, no block-wide barrier.  The warp stages only the n valid rows of
//     k and v (float4 copies, chunks of KC = 32 keys); lane l owns query rows
//     l and l + 32 in turn, keeps q_i in registers (direct float4 loads, as o
//     is stored) and makes one online-softmax pass over the staged keys: one
//     dot a key, a running max, a rescaled normaliser and o accumulator; the
//     k_j and v_j reads are broadcasts.  A second chunk (n > 32) carries the
//     state over.  A len = 0 pair stages nothing: o_i is the mean of all T
//     rows of v, taken once, and P is 1/T.
//     The saving forward then writes P without a (T, T) tile: q goes where
//     the chunk was, each row's final max and 1/l sit beside it, and for a
//     block of rows G = 8, 16 or 32 lanes a row (by n) compute the valid
//     keys' P_ij = exp(s_ij - m_i) / l_i into a tile of n columns; the warp
//     then writes those rows of P once, lanes on consecutive elements, 0 at
//     masked keys.  Writing the valid block first and the zeros after, each
//     by its own stores, was slower in f32 than a block per pair on an H100.
//     ptxas (sm_90a), no spills: inference 79 registers, 16,448 B of static
//     shared memory a block (4,112 a warp); saving 80 registers, 34,816 B
//     (8,704 a warp).  Registers allow 24 warps an SM (6 blocks; for the
//     saving forward shared memory allows the same).  A warp waits on its
//     loads in sequence (lengths, key chunk, q rows) with nothing of the next
//     pair in flight, and the saving forward's P phase runs after the pass;
//     PERF.md has the times.
//   * Backward: bound by bytes (below), and on the train path most keys are
//     masked (mean n 7.6 of T = 51).  One warp per (b, h), BWD_WARPS = 4
//     pairs a block, no block-wide barrier (only __syncwarp).  Query rows go
//     in batches of ROWS = 16: the warp stages the batch's q and do rows and
//     its P tile, the first n columns only (row pitch KC + 2, conflict-free
//     for every walk below), and the k and v rows of the valid keys, in
//     chunks of KC = 32 keys.  Four phases a batch, each with work for every
//     lane and no chain of shuffles per row:
//       - D_i = sum_j P_ij (do_i . v_j) = do_i . o_i, o_i = sum_j P_ij v_j:
//         two lanes a row, half of o_i each, one shuffle;
//       - dl_ij = P_ij (do_i . v_j - D_i) / sqrt(d), written over P: the
//         lane pair of row i takes the keys j of its parity;
//       - dq_i = sum_j dl_ij k_j from the tile and the staged k rows (the
//         shared-tile route; two lanes a row, 8 components each; a second
//         key chunk adds to the first's);
//       - dv_j += sum_i P_ij do_i (before dl overwrites P) and dk_j +=
//         sum_i dl_ij q_i in registers, S lanes a key with 16/S components
//         each: S = 4 for n <= 8, 2 for n <= 16, else 1.
//     Keys beyond 32 (n > KC, rare on the train path) take a second chunk;
//     D_i then comes first from a pass with one warp sum a row, over both
//     chunks.  Rows j >= n of dk and dv are float4 stores of zeros, and a
//     len = 0 pair takes a short branch: dq = dk = 0, dv = P^T do over all T
//     keys from P as saved.  Nothing loops over masked keys, and every
//     output element has one owner lane: no atomics.
//     ptxas (sm_90a): 128 registers, 34,304 B of static shared memory a
//     block (8,576 a warp), no spills; registers allow 4 blocks, 16 warps an
//     SM (shared memory would allow 6).  Capping registers
//     (__launch_bounds__ with 6 or 8 blocks an SM) spills and ran slower on
//     an H100; 2 warps a block ran no faster.  PERF.md has the times and
//     what still holds the kernel back.
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
// block or a warp; the backward's 8 T n d FLOP take under a seventh of its
// byte bound at f32 rates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 16;            // head width
constexpr int T_MAX = 64;        // longest sequence
constexpr int FWD_WARPS = 4;     // forward: (b, h) pairs a block, one warp each
constexpr int BWD_WARPS = 4;     // backward: (b, h) pairs a block, one warp each
constexpr int ROWS = 16;         // backward: query rows staged a batch
constexpr int KC = 32;           // keys a chunk (forward and backward)
constexpr int TP = KC + 2;       // backward: row pitch of a warp's P / dl tile
constexpr float SCALE = 0.25f;   // 1 / sqrt(D), exact
constexpr float NEG_INF = -4294967295.0f;  // -(2^32) + 1, the reference's mask
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ void zero(float (&a)[D]) {
#pragma unroll
  for (int c = 0; c < D; ++c) a[c] = 0.f;
}

// rows x D floats, global -> shared, float4 copies by the lanes of one warp
__device__ __forceinline__ void warp_stage(float* dst, const float* __restrict__ src, int rows,
                                           int lane) {
  for (int x = lane; x < rows * (D / 4); x += 32) {
    reinterpret_cast<float4*>(dst)[x] = reinterpret_cast<const float4*>(src)[x];
  }
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// One warp's shared memory in the forward: the k and v rows of one chunk of
// KC keys, then (saving forward) the pair's q rows in the same place; and for
// the saving forward a tile of P's valid columns for a block of rows, and each
// query row's final max and 1 / normaliser.
constexpr int TILE = 1024;       // saving forward: floats of a warp's P tile
template <bool SAVE>
struct __align__(16) FwdWarp {
  float buf[2 * KC * D];
  float tile[SAVE ? TILE : 1];
  float rowmax[SAVE ? T_MAX : 1];
  float rowinv[SAVE ? T_MAX : 1];
};
static_assert(2 * KC * D >= T_MAX * D, "q rows must fit where the key chunk was");
static_assert(TILE >= T_MAX * 16, "a P tile must hold 16 rows of 64 keys");

// len = 0: every score is NEG_INF, so each row is the mean of all T rows of v.
// Lane l sums component l % 16 over the rows of parity l / 16.
__device__ __forceinline__ void fwd_uniform(const float* __restrict__ v, float* __restrict__ out,
                                            int T, int lane) {
  const int c = lane & (D - 1);
  float sum = 0.f;
  for (int j = lane >> 4; j < T; j += 2) sum += v[j * D + c];
  sum += __shfl_xor_sync(FULL, sum, 16);
  const float mean = sum * (1.0f / static_cast<float>(T));
  const int c4 = (lane & 3) * 4;  // float4 x of the row holds components 4 (x % 4) ..
  const float4 o = make_float4(__shfl_sync(FULL, mean, c4), __shfl_sync(FULL, mean, c4 + 1),
                               __shfl_sync(FULL, mean, c4 + 2), __shfl_sync(FULL, mean, c4 + 3));
  for (int x = lane; x < T * (D / 4); x += 32) reinterpret_cast<float4*>(out)[x] = o;
}

// P of a pair with n >= 1 valid keys, in blocks of rows that fit the tile.
// First P_ij = exp(q_i . k_j / sqrt(d) - m_i) / l_i for the valid keys into
// the tile: G lanes a row on G consecutive keys, 32 / G rows at once, k_j in
// registers, q_i a shared-memory broadcast from buf.  Then the block's rows
// of P are written once, lanes on consecutive elements of the flattened
// (T, T) block, 0 at the masked keys.
template <int G, typename PT>
__device__ __forceinline__ void fwd_probs(FwdWarp<true>& s, const float* __restrict__ k,
                                          PT* __restrict__ p, int n, int T, int lane) {
  constexpr int R = 32 / G;
  const int pitch = (n + G - 1) / G * G;
  const int rows = TILE / pitch;
  const int jj = lane % G, rr = lane / G;
  for (int r0 = 0; r0 < T; r0 += rows) {
    const int r1 = min(T, r0 + rows);
    for (int j = jj; j < n; j += G) {
      float kj[D];
      load_row(kj, k + j * D);
      for (int i = r0 + rr; i < r1; i += R) {
        s.tile[(i - r0) * pitch + j] =
            expf(dot(kj, s.buf + i * D) * SCALE - s.rowmax[i]) * s.rowinv[i];
      }
    }
    __syncwarp();
    int i = r0 + lane / T, j = lane % T;  // row and key of element x
    for (int x = r0 * T + lane; x < r1 * T; x += 32) {
      put(p + x, j < n ? s.tile[(i - r0) * pitch + j] : 0.f);
      j += 32;
      while (j >= T) {
        j -= T;
        ++i;
      }
    }
    __syncwarp();  // the next block of rows overwrites the tile
  }
}

template <bool SAVE, typename PT>
__global__ void __launch_bounds__(FWD_WARPS * 32)
bst_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ lengths,
                         float* __restrict__ out, PT* __restrict__ probs, int H, int T,
                         int pairs) {
  __shared__ FwdWarp<SAVE> warps[FWD_WARPS];
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  if (bh >= pairs) return;  // whole warps only: no block-wide barrier follows
  FwdWarp<SAVE>& s = warps[threadIdx.x >> 5];
  const size_t base = static_cast<size_t>(bh) * T * D;
  q += base; k += base; v += base; out += base;
  const int n = clip_len(lengths[bh / H], T);
  if (n == 0) {
    fwd_uniform(v, out, T, lane);
  } else {
    // lane l owns query rows l and l + 32; one online-softmax pass over the
    // staged keys, chunk by chunk (a second chunk only when n > KC)
    float* ks = s.buf;
    float* vs = s.buf + KC * D;
    int staged = -1;
    for (int r0 = 0; r0 < T; r0 += 32) {
      const int i = r0 + lane;
      float qi[D], acc[D];
      zero(acc);
      if (i < T) load_row(qi, q + i * D); else zero(qi);
      float m = NEG_INF, l = 0.f;  // exp(NEG_INF - s) is exactly 0
      for (int c = 0; KC * c < n; ++c) {
        const int nc = min(KC, n - KC * c);
        if (staged != c) {  // warp-uniform
          __syncwarp();
          warp_stage(ks, k + KC * c * D, nc, lane);
          warp_stage(vs, v + KC * c * D, nc, lane);
          __syncwarp();
          staged = c;
        }
        for (int jj = 0; jj < nc; ++jj) {
          const float sc = dot(qi, ks + jj * D) * SCALE;
          const float mn = fmaxf(m, sc);
          const float corr = expf(m - mn);
          const float p = expf(sc - mn);
          l = fmaf(l, corr, p);
          const float4* vr = reinterpret_cast<const float4*>(vs + jj * D);
#pragma unroll
          for (int w = 0; w < D / 4; ++w) {
            const float4 x = vr[w];
            acc[4 * w] = fmaf(p, x.x, acc[4 * w] * corr);
            acc[4 * w + 1] = fmaf(p, x.y, acc[4 * w + 1] * corr);
            acc[4 * w + 2] = fmaf(p, x.z, acc[4 * w + 2] * corr);
            acc[4 * w + 3] = fmaf(p, x.w, acc[4 * w + 3] * corr);
          }
          m = mn;
        }
      }
      if (i < T) {
        const float il = 1.0f / l;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] *= il;
        store_row(out + i * D, acc);
        if constexpr (SAVE) {
          s.rowmax[i] = m;
          s.rowinv[i] = il;
        }
      }
    }
  }
  if constexpr (SAVE) {
    PT* p = probs + static_cast<size_t>(bh) * T * T;
    if (n == 0) {  // uniform over all T keys
      const float u = 1.0f / static_cast<float>(T);
      for (int x = lane; x < T * T; x += 32) put(p + x, u);
    } else {
      __syncwarp();  // the key chunk is dead: q takes its place
      warp_stage(s.buf, q, T, lane);
      __syncwarp();
      if (n <= 8) {
        fwd_probs<8>(s, k, p, n, T, lane);
      } else if (n <= 16) {
        fwd_probs<16>(s, k, p, n, T, lane);
      } else {
        fwd_probs<32>(s, k, p, n, T, lane);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float* acc, float a, const float4 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

// One warp's shared memory in the backward: a batch of ROWS query rows of q
// and do, the k and v rows of one chunk of KC keys, the batch's P tile
// (overwritten in place by dl) and the row sums D_i.
struct __align__(16) BwdWarp {
  float q[ROWS * D];
  float dout[ROWS * D];
  float k[KC * D];
  float v[KC * D];
  float tile[ROWS * TP];
  float rowsum[T_MAX];
};

// len = 0: every P_ij is the saved 1/T, dl is 0.  dq = dk = 0 and
// dv_j = sum_i P_ij do_i over all T keys, from P as saved (f32 or bf16).
template <typename PT>
__device__ void bwd_uniform(const PT* __restrict__ p, const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int T, int lane) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = lane; x < T * (D / 4); x += 32) {
    reinterpret_cast<float4*>(dq)[x] = z;
    reinterpret_cast<float4*>(dk)[x] = z;
  }
  for (int j = lane; j < T; j += 32) {
    float acc[D];
    zero(acc);
    for (int i = 0; i < T; ++i) axpy(acc, get(p + i * T + j), dout + i * D);
    store_row(dv + j * D, acc);
  }
}

// The n >= 1 valid keys of one (b, h), in chunks of KC, query rows in
// batches of ROWS.  Row phases give lane l half l & 1 of batch row l >> 1;
// key phases give it components [(l % S) W, (l % S + 1) W) of chunk key
// l / S, W = D / S, so that S lanes share a key when n <= 32 / S.  Pointers
// are the pair's own rows; rowsum already holds every D_i when `two`.
template <int S, typename PT>
__device__ __forceinline__ void bwd_keys(BwdWarp& s, const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v, const PT* __restrict__ p,
                                         const float* __restrict__ dout, float* __restrict__ dq,
                                         float* __restrict__ dk, float* __restrict__ dv, int n,
                                         int T, bool two, int lane) {
  constexpr int W = D / S;
  const int kj = lane / S, k0 = (lane % S) * W;
  const int r = lane >> 1, h = lane & 1;
  for (int c = 0; KC * c < n; ++c) {
    const int nc = min(KC, n - KC * c);
    float dkj[W], dvj[W];
#pragma unroll
    for (int w = 0; w < W; ++w) dkj[w] = dvj[w] = 0.f;
    warp_stage(s.k, k + KC * c * D, nc, lane);
    warp_stage(s.v, v + KC * c * D, nc, lane);
    for (int rb = 0; rb < T; rb += ROWS) {
      const int rows = min(ROWS, T - rb);
      warp_stage(s.q, q + rb * D, rows, lane);
      warp_stage(s.dout, dout + rb * D, rows, lane);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {  // the chunk's valid columns of P only
        if (i < rows && lane < nc) s.tile[i * TP + lane] = get(p + (rb + i) * T + KC * c + lane);
      }
      __syncwarp();
      if (!two) {  // D_i = sum_j P_ij (do_i . v_j) = do_i . o_i, o_i = sum_j P_ij v_j
        float part = 0.f;
        if (r < rows) {
          float o[D / 2];
#pragma unroll
          for (int w = 0; w < D / 2; ++w) o[w] = 0.f;
#pragma unroll 4
          for (int jj = 0; jj < nc; ++jj) {
            const float a = s.tile[r * TP + jj];
            const float4* vr = reinterpret_cast<const float4*>(s.v + jj * D + h * (D / 2));
            fma4(o, a, vr[0]);
            fma4(o + 4, a, vr[1]);
          }
          const float4* dr = reinterpret_cast<const float4*>(s.dout + r * D + h * (D / 2));
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float4 y = dr[x];
            part += o[4 * x] * y.x + o[4 * x + 1] * y.y + o[4 * x + 2] * y.z + o[4 * x + 3] * y.w;
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (h == 0 && r < rows) s.rowsum[rb + r] = part;
      }
      if (kj < nc) {  // dv_j += sum_i P_ij do_i
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
          const float a = s.tile[i * TP + kj];
          const float4* dr = reinterpret_cast<const float4*>(s.dout + i * D + k0);
#pragma unroll
          for (int w = 0; w < W / 4; ++w) fma4(dvj + 4 * w, a, dr[w]);
        }
      }
      __syncwarp();
      if (r < rows) {  // dl_ij = P_ij (do_i . v_j - D_i) / sqrt(d) in place of P; lane h: j = h mod 2
        float dor[D];
        load_row(dor, s.dout + r * D);
        const float di = s.rowsum[rb + r];
#pragma unroll 2
        for (int jj = h; jj < nc; jj += 2) {
          float* t = s.tile + r * TP + jj;
          *t = *t * (dot(dor, s.v + jj * D) - di) * SCALE;
        }
      }
      __syncwarp();
      if (r < rows) {  // dq_i (+)= sum_j dl_ij k_j, half h of row r
        float acc[D / 2];
#pragma unroll
        for (int w = 0; w < D / 2; ++w) acc[w] = 0.f;
#pragma unroll 4
        for (int jj = 0; jj < nc; ++jj) {
          const float a = s.tile[r * TP + jj];
          const float4* kr = reinterpret_cast<const float4*>(s.k + jj * D + h * (D / 2));
          fma4(acc, a, kr[0]);
          fma4(acc + 4, a, kr[1]);
        }
        float4* dst = reinterpret_cast<float4*>(dq + (rb + r) * D + h * (D / 2));
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float4 o = make_float4(acc[4 * x], acc[4 * x + 1], acc[4 * x + 2], acc[4 * x + 3]);
          if (c > 0) {  // this lane wrote the first chunk's part
            const float4 prev = dst[x];
            o.x += prev.x; o.y += prev.y; o.z += prev.z; o.w += prev.w;
          }
          dst[x] = o;
        }
      }
      if (kj < nc) {  // dk_j += sum_i dl_ij q_i
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
          const float a = s.tile[i * TP + kj];
          const float4* qr = reinterpret_cast<const float4*>(s.q + i * D + k0);
#pragma unroll
          for (int w = 0; w < W / 4; ++w) fma4(dkj + 4 * w, a, qr[w]);
        }
      }
      __syncwarp();  // the next batch overwrites q, do and the tile
    }
    if (kj < nc) {
      float4* dk4 = reinterpret_cast<float4*>(dk + (KC * c + kj) * D + k0);
      float4* dv4 = reinterpret_cast<float4*>(dv + (KC * c + kj) * D + k0);
#pragma unroll
      for (int w = 0; w < W / 4; ++w) {
        dk4[w] = make_float4(dkj[4 * w], dkj[4 * w + 1], dkj[4 * w + 2], dkj[4 * w + 3]);
        dv4[w] = make_float4(dvj[4 * w], dvj[4 * w + 1], dvj[4 * w + 2], dvj[4 * w + 3]);
      }
    }
  }
}

template <typename PT>
__global__ void __launch_bounds__(BWD_WARPS * 32)
bst_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const PT* __restrict__ probs,
                         const float* __restrict__ dout, const int* __restrict__ lengths,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int T, int pairs) {
  __shared__ BwdWarp warps[BWD_WARPS];
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * BWD_WARPS + (threadIdx.x >> 5);
  if (bh >= pairs) return;  // whole warps only: no block-wide barrier follows
  BwdWarp& s = warps[threadIdx.x >> 5];
  const size_t base = static_cast<size_t>(bh) * T * D;
  q += base; k += base; v += base; dout += base; dq += base; dk += base; dv += base;
  const PT* p = probs + static_cast<size_t>(bh) * T * T;
  const int n = clip_len(lengths[bh / H], T);
  if (n == 0) {
    bwd_uniform(p, dout, dq, dk, dv, T, lane);
    return;
  }
  // Two key chunks (n > KC): D_i must sum over both before any dl is
  // formed, so a first pass over the rows gives every D_i (a warp sum a row).
  const bool two = n > KC;
  if (two) {
    float v0[D], v1[D];
    load_row(v0, v + lane * D);
    const bool has1 = KC + lane < n;
    if (has1) load_row(v1, v + (KC + lane) * D); else zero(v1);
    for (int i = 0; i < T; ++i) {
      const float* doi = dout + i * D;
      const float p1 = has1 ? get(p + i * T + KC + lane) : 0.f;
      const float r = warp_sum(get(p + i * T + lane) * dot(v0, doi) + p1 * dot(v1, doi));
      if (lane == 0) s.rowsum[i] = r;
    }
    __syncwarp();
  }
  if (n <= KC / 4) {
    bwd_keys<4>(s, q, k, v, p, dout, dq, dk, dv, n, T, two, lane);
  } else if (n <= KC / 2) {
    bwd_keys<2>(s, q, k, v, p, dout, dq, dk, dv, n, T, two, lane);
  } else {
    bwd_keys<1>(s, q, k, v, p, dout, dq, dk, dv, n, T, two, lane);
  }
  // keys j >= n pass nothing: zeros written, not computed
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = n * (D / 4) + lane; x < T * (D / 4); x += 32) {
    reinterpret_cast<float4*>(dk)[x] = z;
    reinterpret_cast<float4*>(dv)[x] = z;
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
  const int pairs = B * H;
  const int blocks = (pairs + FWD_WARPS - 1) / FWD_WARPS;
  if (save == 0) {
    bst_attention_fwd_kernel<false, float><<<blocks, FWD_WARPS * 32, 0, st>>>(
        q, k, v, lengths, out, nullptr, H, T, pairs);
  } else if (save == 1) {
    bst_attention_fwd_kernel<true, float><<<blocks, FWD_WARPS * 32, 0, st>>>(
        q, k, v, lengths, out, static_cast<float*>(probs), H, T, pairs);
  } else {
    bst_attention_fwd_kernel<true, __nv_bfloat16><<<blocks, FWD_WARPS * 32, 0, st>>>(
        q, k, v, lengths, out, static_cast<__nv_bfloat16*>(probs), H, T, pairs);
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
  const int pairs = B * H;
  const int blocks = (pairs + BWD_WARPS - 1) / BWD_WARPS;
  if (probs_bf16) {
    bst_attention_bwd_kernel<__nv_bfloat16><<<blocks, BWD_WARPS * 32, 0, st>>>(
        q, k, v, static_cast<const __nv_bfloat16*>(probs), dout, lengths, dq, dk, dv, H, T,
        pairs);
  } else {
    bst_attention_bwd_kernel<float><<<blocks, BWD_WARPS * 32, 0, st>>>(
        q, k, v, static_cast<const float*>(probs), dout, lengths, dq, dk, dv, H, T, pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
