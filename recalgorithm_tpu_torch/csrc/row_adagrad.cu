// Row-wise Adagrad over a row gradient, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package updates a table with optax's
// dense Adagrad, over every row, and so did the port: its multi-tensor chain
// reads and writes the whole table, its accumulator and a dense (V, dim)
// gradient about 20 times a step.  A table's step touches only the rows its
// ids reach (DLRM-DCNv2's tables: 4.9% of 25.6M rows), and a row whose
// gradient is 0 does not move (acc += 0; p -= lr * 0 * rsqrt(acc + eps) or,
// where acc = 0, nothing), so updating the touched rows alone is the same
// update.  This kernel takes the lookups' uncoalesced row gradient (each id
// beside its gradient row, embed/tables.row_sparse_grads) after the wrapper
// sorted the ids, and for each distinct row r with summed gradient g does, in
// place and in the dense chain's order of operations,
//
//   acc_r += g * g;   p_r += (-lr) * ((rsqrt(acc_r + eps) * sign(acc_r)) * g)
//
// (the product g * g and the sums are not contracted into an FMA; the last
// line is one, as the dense chain's add with alpha is).
//
// Bound: bytes.  The least traffic reads each sorted id and its position
// (4 + 8 B), each id's gradient row (4 dim B), and reads and writes each
// distinct row's parameter and accumulator once (16 dim B); there is one
// multiply-add or so a byte.  chip_smoke.py's phase 19 counts exactly that
// over 3.35 TB/s.
//
// Design.  One warp a chunk of CHUNK = 32 consecutive sorted positions; the
// lanes own a row's columns (a float4 each, dim 128 in one pass), so every
// gradient, parameter and accumulator row is read as whole 128-byte lines.
// The warp holds its chunk's 32 ids and positions one a lane, loads the
// chunk's gradient rows UNROLL at a time (independent loads in flight), and
// sums each run of equal ids in position order (the sort is stable).
//   * A run that begins and ends inside the chunk is a whole row: the warp
//     applies the update at once.
//   * A run cut by the chunk's edge belongs to a segment that spans several
//     chunks (a small table, or a hot id such as a batch's PAD row).  Its
//     chunks add their partial sums into f32 scratch at the slot of the
//     chunk that holds the segment's first position (red.global.add), so no
//     warp walks more than its own 32 positions.  Each then counts itself in
//     the slot's counter after a fence; the warp that brings the count to the
//     number of chunks the segment spans reads the total from L2 and applies
//     the update.  A warp finds the segment's first and last position by a
//     32-way search of the sorted ids (a few rounds of one load a lane).
//   The order of those atomic adds varies from run to run, so a row whose ids
//   span three or more chunks gets its sum in varying order (its last bits
//   vary); every other row is summed in position order.
// Nothing synchronizes with the host: every size is the id count, which the
// host knows; the wrapper zeroes the scratch and its counters.
//
// Measured on an H100 SXM (80 GB HBM3, 700 W power limit; chip_smoke.py
// phase 19): ptxas 71-77 registers (float4) and 40 (scalar), no spills.  At
// DLRM-DCNv2's 5,000,192-row table read by the 100-hot bag at B = 8192
// (819,200 ids, 702,910 distinct rows) 0.66 ms against the 0.558 ms bound
// (84-85%), where the dense chain took 19.1 ms over the table; the 3-row
// table at 8192 ids (three segments of about 2,700) 0.011 ms against 0.0013,
// its time the atomics and searches of the long segments.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;  // sorted positions a warp; one id a lane
constexpr int WARPS = 8;   // warps a block
constexpr unsigned FULL = 0xffffffffu;

template <int VEC> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ void vzero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void vzero(float& a) { a = 0.f; }

__device__ __forceinline__ float adagrad1(float& acc, float p, float g, float neg_lr,
                                          float eps) {
  const float a = __fadd_rn(acc, __fmul_rn(g, g));
  const float sgn = static_cast<float>((0.f < a) - (a < 0.f));
  const float r = __fmul_rn(rsqrtf(__fadd_rn(a, eps)), sgn);
  acc = a;
  return fmaf(neg_lr, __fmul_rn(r, g), p);
}

__device__ __forceinline__ void adagrad(float4& acc, float4& p, float4 g, float neg_lr,
                                        float eps) {
  p.x = adagrad1(acc.x, p.x, g.x, neg_lr, eps);
  p.y = adagrad1(acc.y, p.y, g.y, neg_lr, eps);
  p.z = adagrad1(acc.z, p.z, g.z, neg_lr, eps);
  p.w = adagrad1(acc.w, p.w, g.w, neg_lr, eps);
}
__device__ __forceinline__ void adagrad(float& acc, float& p, float g, float neg_lr,
                                        float eps) {
  p = adagrad1(acc, p, g, neg_lr, eps);
}

// The update of row `row` with its summed gradient, lane's columns.
template <int VEC, int PER>
__device__ __forceinline__ void apply(const typename VecOf<VEC>::T (&g)[PER], int row,
                                      float* __restrict__ param, float* __restrict__ acc,
                                      int rows, int vecs, int lane, float neg_lr, float eps) {
  using V = typename VecOf<VEC>::T;
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(rows)) return;
  V* pr = reinterpret_cast<V*>(param) + static_cast<size_t>(row) * vecs;
  V* ar = reinterpret_cast<V*>(acc) + static_cast<size_t>(row) * vecs;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int c = lane + 32 * q;
    if (c < vecs) {
      V a = ar[c], p = pr[c];
      adagrad(a, p, g[q], neg_lr, eps);
      ar[c] = a;
      pr[c] = p;
    }
  }
}

// First position of `key` in keys[0..hi], where keys[hi] == key (sorted).
__device__ int first_of(const int* __restrict__ keys, int key, int hi, int lane) {
  int lo = 0;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = min(lo + lane * step, hi);
    const unsigned eq = __ballot_sync(FULL, keys[p] == key);
    if (eq == 0) {
      lo = lo + 31 * step + 1;
    } else {
      const int f = __ffs(eq) - 1;
      if (f == 0) return lo;
      hi = min(lo + f * step, hi);
      lo = lo + (f - 1) * step + 1;
    }
  }
  return lo;
}

// Last position of `key` in keys[lo..n-1], where keys[lo] == key (sorted).
__device__ int last_of(const int* __restrict__ keys, int key, int lo, int n, int lane) {
  int hi = n - 1;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = max(hi - lane * step, lo);
    const unsigned eq = __ballot_sync(FULL, keys[p] == key);
    if (eq == 0) {
      hi = hi - 31 * step - 1;
    } else {
      const int f = __ffs(eq) - 1;
      if (f == 0) return hi;
      lo = max(hi - f * step, lo);
      hi = hi - (f - 1) * step - 1;
    }
  }
  return hi;
}

template <int VEC, int PER>
__global__ void __launch_bounds__(WARPS * 32)
row_adagrad_kernel(const int* __restrict__ keys, const int64_t* __restrict__ order,
                   const float* __restrict__ values, float* __restrict__ param,
                   float* __restrict__ acc, float* __restrict__ scratch, int* __restrict__ count,
                   int n, int rows, int vecs, float neg_lr, float eps) {
  using V = typename VecOf<VEC>::T;
  constexpr int UNROLL = 8 / PER;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int start = chunk * CHUNK;
  if (start >= n) return;
  const int len = min(CHUNK, n - start);
  const int end = start + len;
  const int my_key = lane < len ? keys[start + lane] : -1;
  const int64_t my_pos = lane < len ? order[start + lane] : 0;
  const int before = start > 0 ? keys[start - 1] : -1;  // ids are >= 0
  const int after = end < n ? keys[end] : -1;
  const V* vrows = reinterpret_cast<const V*>(values);

  V sum[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) vzero(sum[q]);
  int run_start = 0;
  for (int j0 = 0; j0 < len; j0 += UNROLL) {
    V v[UNROLL][PER];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t pos = __shfl_sync(FULL, my_pos, (j0 + u) & 31);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int c = lane + 32 * q;
        if (j0 + u < len && c < vecs) {
          v[u][q] = vrows[pos * vecs + c];
        } else {
          vzero(v[u][q]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      if (j >= len) break;  // warp-uniform
      const int key = __shfl_sync(FULL, my_key, j);
      const int next = __shfl_sync(FULL, my_key, (j + 1) & 31);
#pragma unroll
      for (int q = 0; q < PER; ++q) sum[q] = vadd(sum[q], v[u][q]);
      const bool last_here = j + 1 == len;
      if (!last_here && next == key) continue;  // the run goes on
      const bool head_here = run_start > 0 || before != key;
      const bool tail_here = !last_here || after != key;
      if (head_here && tail_here) {
        apply<VEC, PER>(sum, key, param, acc, rows, vecs, lane, neg_lr, eps);
      } else {
        const int head = head_here ? start + run_start : first_of(keys, key, start - 1, lane);
        const int tail = tail_here ? start + j : last_of(keys, key, end, n, lane);
        const int slot = head / CHUNK;
        const int parts = tail / CHUNK - slot + 1;
        float* s = scratch + static_cast<size_t>(slot) * vecs * VEC;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int c = lane + 32 * q;
          if (c < vecs) {
            const float* part = reinterpret_cast<const float*>(&sum[q]);
#pragma unroll
            for (int e = 0; e < VEC; ++e) atomicAdd(s + c * VEC + e, part[e]);
          }
        }
        __threadfence();
        __syncwarp();
        int prior = 0;
        if (lane == 0) prior = atomicAdd(count + slot, 1);
        prior = __shfl_sync(FULL, prior, 0);
        if (prior == parts - 1) {  // every part is in: this warp applies the row
          __threadfence();
          V total[PER];
#pragma unroll
          for (int q = 0; q < PER; ++q) {
            const int c = lane + 32 * q;
            vzero(total[q]);
            if (c < vecs) total[q] = __ldcg(reinterpret_cast<const V*>(s) + c);
          }
          apply<VEC, PER>(total, key, param, acc, rows, vecs, lane, neg_lr, eps);
        }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) vzero(sum[q]);
      run_start = j + 1;
    }
  }
}

template <int VEC, int PER>
int launch(const int* keys, const int64_t* order, const float* values, float* param,
           float* acc, float* scratch, int* count, int n, int rows, int dim, float neg_lr,
           float eps, cudaStream_t stream) {
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const int blocks = (chunks + WARPS - 1) / WARPS;
  row_adagrad_kernel<VEC, PER><<<blocks, WARPS * 32, 0, stream>>>(
      keys, order, values, param, acc, scratch, count, n, rows, dim / VEC, neg_lr, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Updates the distinct rows of `keys` (n sorted ids in [0, rows), int32;
// `order` their int64 positions in `values`, (n, dim) f32) in `param` and
// `acc` ((rows, dim) f32, in place).  `scratch` holds ceil(n / 32) * dim
// floats and `count` ceil(n / 32) ints, all zero.  dim % 4 == 0 takes the
// float4 path (16-byte aligned rows), any other dim the scalar one, up to
// 512 (float4) or 128 (scalar).  Returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int row_adagrad(const int* keys, const int64_t* order, const float* values,
                           float* param, float* acc, float* scratch, int* count, int n,
                           int rows, int dim, float lr, float eps, void* stream) {
  if (n < 0 || rows < 1 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float neg_lr = -lr;
  if (dim % 4 == 0) {
    const int vecs = dim / 4;
    if (vecs <= 32)
      return launch<4, 1>(keys, order, values, param, acc, scratch, count, n, rows, dim, neg_lr, eps, st);
    if (vecs <= 64)
      return launch<4, 2>(keys, order, values, param, acc, scratch, count, n, rows, dim, neg_lr, eps, st);
    if (vecs <= 128)
      return launch<4, 4>(keys, order, values, param, acc, scratch, count, n, rows, dim, neg_lr, eps, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dim <= 32)
    return launch<1, 1>(keys, order, values, param, acc, scratch, count, n, rows, dim, neg_lr, eps, st);
  if (dim <= 64)
    return launch<1, 2>(keys, order, values, param, acc, scratch, count, n, rows, dim, neg_lr, eps, st);
  if (dim <= 128)
    return launch<1, 4>(keys, order, values, param, acc, scratch, count, n, rows, dim, neg_lr, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
