// Sequential count-min update+estimate for one tenant (kernel K1).
//
// Replaces redisson_tpu/ops/pallas_cms.py:_kernel (the Pallas kernel behind
// cms_update_estimate_seq) and computes exactly its golden model golden_seq:
// ops are applied in arrival order; for op j and depth row r the cell is
// idx_r = (h1 + r*h2) mod w (by conditional subtraction, h1 and h2
// pre-reduced mod w, w <= 2^31), weight_j is added to table[r, idx_r], and
// est_j is the unsigned minimum over r of the updated cells.  So est_j counts
// every op <= j and no later op.  All arithmetic is uint32 with wrap.
//
// Design.  Depth rows are independent, so each row gets one warp (one block
// of 32 threads per row).  A warp walks the ops in chunks of 32, one op per
// lane, in order.  Lanes whose ops hit the same cell form a group
// (__match_any_sync); each lane's value is the cell as it stood before the
// chunk plus the inclusive prefix of its group's weights, and the group's
// last lane stores cell + group total.  __syncwarp() orders every load of a
// chunk before its stores, and the stores before the next chunk's loads.
// Each lane folds its value into est[j] with atomicMin, which is
// order-independent, so the result is exact; the wrapper fills est with
// 0xFFFFFFFF.  The table is updated in place at the tenant row's offset in
// the pool: 5 x 65536 counters are 1.3 MB, resident in L2 (it does not fit
// the 227 KB of shared memory).
//
// Bound.  The chain of B/32 dependent L2 round trips per warp bounds this
// kernel (memory latency through L2), far above the card's bandwidth bound
// for the bytes it moves.  A later version could sort the ops by cell and
// scan (the plain PyTorch version's shape, parallel over ops), or keep a
// shared-memory tile of the hot cells a skewed stream keeps hitting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kNoCell = 0xFFFFFFFFu;  // inactive lanes; never a cell

__global__ void cms_seq_kernel(uint32_t* table, const uint32_t* __restrict__ h1,
                               const uint32_t* __restrict__ h2,
                               const uint32_t* __restrict__ wt,
                               uint32_t* __restrict__ est, int n_ops, int w) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t width = static_cast<uint32_t>(w);
  uint32_t* row = table + static_cast<size_t>(r) * width;
  for (int base = 0; base < n_ops; base += 32) {
    const int j = base + lane;
    const bool active = j < n_ops;
    uint32_t cell = kNoCell, weight = 0u, cur = 0u;
    if (active) {
      uint32_t idx = h1[j];
      const uint32_t step = h2[j];
      for (int i = 0; i < r; ++i) {
        idx += step;
        if (idx >= width) idx -= width;
      }
      cell = idx;
      weight = wt[j];
      cur = row[cell];
    }
    const unsigned group = __match_any_sync(kFullMask, cell);
    uint32_t prefix = 0u, total = 0u;
    for (int src = 0; src < 32; ++src) {
      const uint32_t ws = __shfl_sync(kFullMask, weight, src);
      if ((group >> src) & 1u) {
        total += ws;
        if (src <= lane) prefix += ws;
      }
    }
    __syncwarp();
    if (active) {
      atomicMin(&est[j], cur + prefix);
      if (lane == 31 - __clz(static_cast<int>(group))) row[cell] = cur + total;
    }
    __syncwarp();
  }
}

}  // namespace

// table: the tenant's d*w counters (uint32, updated in place); h1, h2,
// weights, est: uint32[n_ops].  Returns cudaGetLastError() after the launch.
extern "C" int cms_seq_launch(void* table, const void* h1, const void* h2,
                              const void* weights, void* est, int n_ops, int d,
                              int w, void* stream) {
  cms_seq_kernel<<<d, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(table), static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<const uint32_t*>(weights),
      static_cast<uint32_t*>(est), n_ops, w);
  return static_cast<int>(cudaGetLastError());
}
