// Sequential count-min update+estimate for one tenant (kernel K1).
//
// Replaces redisson_tpu/ops/pallas_cms.py:_kernel (the Pallas kernel behind
// cms_update_estimate_seq) and computes exactly its golden model golden_seq:
// ops are applied in arrival order; for op j and depth row r the cell is
// idx_r = (h1 + r*h2) mod w (h1 and h2 pre-reduced mod w, w < 2^31),
// weight_j is added to table[r, idx_r], and est_j is the unsigned minimum
// over r of the updated cells.  So est_j counts every op <= j and no later
// op.  All arithmetic is uint32 with wrap.  The table is updated in place at
// the tenant row's offset in the pool.
//
// Tiles in shared memory.  Rows are independent, and within a row so are
// cells: only ops that hit one cell must be applied in order.  Each row is
// cut into tiles of tile_w cells (the last one may be ragged), and a block
// owns one (row, tile) work item at a time (grid-stride over d * tiles).
// The wrapper's plan (ops/cms_seq.py:_plan) sizes tiles so that d * tiles
// fills the card's SMs once; at d=5, w=65536 that is 130 tiles of 2528
// cells.  A block copies its tile into shared memory with a plain coalesced
// word loop (every geometry takes that path: no bulk copy, so nothing needs
// 16-byte alignment), applies every op that hits it, and writes it back.
//
// Arrival order.  Warps 1-15 filter: each chunk of 3840 ops is cut into 15
// consecutive segments of 256, 8 ops per lane.  A warp loads chunk c+1's
// ops into one of two register sets while it filters chunk c from the
// other: it computes the row-r cells of its 8 ops side by side (the
// reference's conditional subtraction, r steps) and keeps the ops inside
// the tile.  A ballot plus popc ranks the kept ops in the warp, a barrier
// among the 15 filter warps publishes each warp's count, and each warp
// writes its ops after those of the segments before it: the kept list is
// in arrival order.  After a second barrier the filter warps prepare the
// list's windows of 32 ops: lanes that hit one cell form a group
// (__match_any_sync), each weight is replaced by the inclusive prefix of
// its group's weights (for weights in {0, 1} popc(group & ones &
// lanemask_le), otherwise a five-round pointer-jumping scan along the
// group), and the group's last op is marked.  Warp 0 walks the previous
// chunk's list (two list buffers, one __syncthreads per chunk, so
// filtering chunk c+1 overlaps walking chunk c) window by window: each
// op's value is its cell before the window plus its prefix, and the marked
// op stores it back.  So the dependent chain per window is one
// shared-memory load, an add and a store.
//
// Estimates.  For each row exactly one block sees op j and folds its value
// into est[j] with atomicMin, which is order-free; the wrapper fills est
// with 0xFFFFFFFF.
//
// Bound, and the worst case under skew.  The bytes bound of the function
// is ~0.94 us at d=5, w=65536, B=32768 (PERF.md).  This kernel is far
// above it because every block reads and filters every op: ~130 blocks
// each read the three op columns (384 KB) from L2 and compute each op's
// row cell, 26 times the work of one pass per row, and each 3840-op step
// is a chain of dependent phases (loads, cells, ballots, two barriers, the
// window prep) with little parallelism inside a block.  That filter sets
// the time for uniform and zipf streams.  The walk of the hottest tile is
// the other limit: a cell hit by n ops costs n/32 windows.  The worst case
// is a stream of one key: every op of a row lands on one cell, one warp
// per row walks B/32 windows of shared-memory latency, and the other
// blocks only filter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;  // warp 0 walks, warps 1..15 filter
constexpr int kThreads = kWarps * 32;
constexpr int kFilterWarps = kWarps - 1;
constexpr int kOpsPerLane = 8;
constexpr int kSegment = 32 * kOpsPerLane;        // ops per filter warp
constexpr int kChunk = kFilterWarps * kSegment;   // 3840 ops per chunk
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr uint32_t kNoCell = 0xFFFFFFFFu;  // dropped ops and idle lanes
constexpr uint32_t kLast = 0x80000000u;  // kept cell word: last of its group

// Dynamic shared memory: tile[tile_w] | cell, weight, op: [2][kChunk] each
// | per-warp counts [kWarps] | list lengths [2].  ops/cms_seq.py:_plan
// mirrors this size.
int smem_bytes(int tile_w) {
  return 4 * (tile_w + 6 * kChunk + kWarps + 2);
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Barrier 1 among the filter warps only (warp 0 keeps walking).
__device__ __forceinline__ void filter_warps_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kFilterWarps * 32) : "memory");
}

// Inclusive prefix of x over the lanes of `group` up to this lane, by
// pointer jumping along each lane's previous group member.
__device__ __forceinline__ uint32_t group_scan(uint32_t x, unsigned group,
                                               int lane) {
  int prev = 31 - __clz(static_cast<int>(group & lanemask_lt()));  // -1: first
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int src = prev < 0 ? lane : prev;
    const uint32_t xp = __shfl_sync(kFullMask, x, src);
    const int pp = __shfl_sync(kFullMask, prev, src);
    if (prev >= 0) {
      x += xp;
      prev = pp;
    }
  }
  return x;
}

// Warp 0: apply one prepared list to the tile in order.  Each kept op
// carries its cell (with kLast on the last op of its group in its window)
// and its group's inclusive prefix, so the dependent chain per window is a
// shared-memory load of the cell, an add and the last op's store.
__device__ void walk(uint32_t* tile, const uint32_t* cells,
                     const uint32_t* prefixes, const uint32_t* ops, uint32_t n,
                     uint32_t* __restrict__ est, int lane) {
  // Loads past the list's end read word 0 (the buffer holds kChunk words)
  // and are never used: no branch between a window's loads.
  uint32_t k = lane;
  uint32_t cell = k < n ? cells[k] : 0u;
  uint32_t prefix = prefixes[k < n ? k : 0], op = ops[k < n ? k : 0];
  for (uint32_t i = 0; i < n; i += 32) {
    const bool active = k < n;
    const uint32_t at = cell & ~kLast;
    const uint32_t cur = active ? tile[at] : 0u;
    k += 32;  // the next window's words do not depend on the tile
    const uint32_t next_cell = k < n ? cells[k] : 0u;
    const uint32_t next_prefix = prefixes[k < n ? k : 0];
    const uint32_t next_op = ops[k < n ? k : 0];
    __syncwarp();  // every load of the window before any store
    if (active) {
      const uint32_t val = cur + prefix;
      atomicMin(&est[op], val);
      if (cell & kLast) tile[at] = val;
    }
    __syncwarp();  // the stores before the next window's loads
    cell = next_cell;
    prefix = next_prefix;
    op = next_op;
  }
}

// Filter warp fw: for the windows fw, fw+15, ... of a complete kept list,
// group the lanes that hit one cell (__match_any_sync), replace each
// weight by the inclusive prefix of its group's weights, and mark the
// group's last lane with kLast.
__device__ __forceinline__ void prepare_windows(uint32_t* cells,
                                                uint32_t* weights, uint32_t n,
                                                int fw, int lane) {
  const uint32_t le = lanemask_lt() | (1u << lane);
  for (uint32_t i = fw * 32; i < n; i += kFilterWarps * 32) {
    const uint32_t k = i + lane;
    const bool active = k < n;
    const uint32_t cell = active ? cells[k] : kNoCell;
    const uint32_t weight = active ? weights[k] : 0u;
    const unsigned group = __match_any_sync(kFullMask, cell);
    uint32_t prefix;
    if (__all_sync(kFullMask, weight <= 1u)) {
      prefix = __popc(group & __ballot_sync(kFullMask, weight) & le);
    } else {
      prefix = group_scan(weight, group, lane);
    }
    if (active) {
      weights[k] = prefix;
      if (lane == 31 - __clz(static_cast<int>(group))) cells[k] = cell | kLast;
    }
  }
}

// A filter warp's ops of one chunk: 8 per lane, lane-consecutive.
struct Ops {
  uint32_t h1[kOpsPerLane], h2[kOpsPerLane], wt[kOpsPerLane];
};

__device__ __forceinline__ void load_ops(Ops& o, const uint32_t* __restrict__ h1,
                                         const uint32_t* __restrict__ h2,
                                         const uint32_t* __restrict__ wt,
                                         uint32_t n_ops, int r, int c, int fw,
                                         int lane) {
  const uint32_t base = static_cast<uint32_t>(c) * kChunk + fw * kSegment + lane;
#pragma unroll
  for (int u = 0; u < kOpsPerLane; ++u) {
    const uint32_t j = base + u * 32;
    const bool valid = j < n_ops;
    o.h1[u] = valid ? h1[j] : 0u;
    o.h2[u] = valid && r > 0 ? h2[j] : 0u;
    o.wt[u] = valid ? wt[j] : 0u;
  }
}

// Keep the loaded ops that hit [lo, lo + len) of row r, in arrival order,
// in one list buffer, and prepare its windows for the walk.
__device__ __forceinline__ void keep_ops(const Ops& o, uint32_t n_ops, int r,
                                         uint32_t w, uint32_t lo, uint32_t len,
                                         int c, int fw, int lane,
                                         uint32_t* cells, uint32_t* weights,
                                         uint32_t* ops, uint32_t* counts,
                                         uint32_t* n_kept) {
  const uint32_t base = static_cast<uint32_t>(c) * kChunk + fw * kSegment + lane;
  // (h1 + r*h2) mod w for h1, h2 < w: the reference's conditional
  // subtraction, r steps for all 8 ops side by side; one 64-bit remainder
  // per op for r >= 16 (the same value).
  uint32_t idx[kOpsPerLane];
#pragma unroll
  for (int u = 0; u < kOpsPerLane; ++u) idx[u] = o.h1[u];
  if (r < 16) {
    for (int i = 0; i < r; ++i) {
#pragma unroll
      for (int u = 0; u < kOpsPerLane; ++u) {
        idx[u] += o.h2[u];
        idx[u] = idx[u] >= w ? idx[u] - w : idx[u];
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kOpsPerLane; ++u)
      idx[u] = static_cast<uint32_t>(
          (static_cast<uint64_t>(o.h1[u]) + static_cast<uint64_t>(r) * o.h2[u]) % w);
  }
  uint32_t local[kOpsPerLane];
  unsigned kept[kOpsPerLane];
  uint32_t count = 0;
#pragma unroll
  for (int u = 0; u < kOpsPerLane; ++u) {
    const uint32_t off = idx[u] - lo;
    local[u] = base + u * 32 < n_ops && off < len ? off : kNoCell;
    kept[u] = __ballot_sync(kFullMask, local[u] != kNoCell);
    count += __popc(kept[u]);
  }
  if (lane == 0) counts[fw] = count;
  filter_warps_sync();
  uint32_t at = 0, total = 0;
  for (int q = 0; q < kFilterWarps; ++q) {
    if (q == fw) at = total;
    total += counts[q];
  }
  if (fw == 0 && lane == 0) *n_kept = total;
  const uint32_t lt = lanemask_lt();
#pragma unroll
  for (int u = 0; u < kOpsPerLane; ++u) {
    if (local[u] != kNoCell) {
      const uint32_t k = at + __popc(kept[u] & lt);
      cells[k] = local[u];
      weights[k] = o.wt[u];
      ops[k] = base + u * 32;
    }
    at += __popc(kept[u]);
  }
  filter_warps_sync();  // the list is complete
  prepare_windows(cells, weights, total, fw, lane);
}

struct Item {
  const uint32_t* h1;
  const uint32_t* h2;
  const uint32_t* wt;
  uint32_t* est;
  uint32_t* tile;
  uint32_t* cells;
  uint32_t* weights;
  uint32_t* ops;
  uint32_t* counts;
  uint32_t* n_kept;
  uint32_t n_ops, w, lo, len;
  int r, n_chunks;
};

// Step c of a work item: the filter warps load chunk c+1 into `next`, then
// keep chunk c (in `cur`, loaded a step earlier) into list buffer c&1,
// while warp 0 walks chunk c-1 from buffer (c-1)&1.
__device__ __forceinline__ void step(const Item& t, int c, Ops& cur, Ops& next,
                                     int warp, int lane) {
  if (warp == 0) {
    if (c > 0) {
      const int p = (c - 1) & 1;
      walk(t.tile, t.cells + p * kChunk, t.weights + p * kChunk,
           t.ops + p * kChunk, t.n_kept[p], t.est, lane);
    }
  } else if (c < t.n_chunks) {
    if (c + 1 < t.n_chunks)
      load_ops(next, t.h1, t.h2, t.wt, t.n_ops, t.r, c + 1, warp - 1, lane);
    const int p = c & 1;
    keep_ops(cur, t.n_ops, t.r, t.w, t.lo, t.len, c, warp - 1, lane,
             t.cells + p * kChunk, t.weights + p * kChunk, t.ops + p * kChunk,
             t.counts, t.n_kept + p);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    cms_seq_kernel(uint32_t* table, const uint32_t* __restrict__ h1,
                   const uint32_t* __restrict__ h2,
                   const uint32_t* __restrict__ wt, uint32_t* __restrict__ est,
                   uint32_t n_ops, int d, uint32_t w, int tile_w,
                   int tiles_per_row) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Item t;
  t.h1 = h1;
  t.h2 = h2;
  t.wt = wt;
  t.est = est;
  t.tile = smem;
  t.cells = t.tile + tile_w;
  t.weights = t.cells + 2 * kChunk;
  t.ops = t.weights + 2 * kChunk;
  t.counts = t.ops + 2 * kChunk;
  t.n_kept = t.counts + kWarps;
  t.n_ops = n_ops;
  t.w = w;
  t.n_chunks = static_cast<int>((n_ops + kChunk - 1) / kChunk);
  const int n_work = d * tiles_per_row;
  for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
    t.r = item / tiles_per_row;
    t.lo = static_cast<uint32_t>(item % tiles_per_row) * tile_w;
    t.len = min(static_cast<uint32_t>(tile_w), w - t.lo);
    uint32_t* src = table + static_cast<size_t>(t.r) * w + t.lo;
    for (uint32_t i = threadIdx.x; i < t.len; i += kThreads) t.tile[i] = src[i];
    __syncthreads();
    // Two register sets of ops, named statically so they stay in registers.
    Ops a, b;
    if (warp > 0) load_ops(a, h1, h2, wt, n_ops, t.r, 0, warp - 1, lane);
    for (int c = 0; c <= t.n_chunks; c += 2) {
      step(t, c, a, b, warp, lane);
      if (c + 1 <= t.n_chunks) step(t, c + 1, b, a, warp, lane);
    }
    for (uint32_t i = threadIdx.x; i < t.len; i += kThreads) src[i] = t.tile[i];
    __syncthreads();  // the tile is free for the next work item
  }
}

}  // namespace

// Dynamic shared memory a launch with this tile width takes.
extern "C" int cms_seq_smem_bytes(int tile_w) { return smem_bytes(tile_w); }

// table: the tenant's d*w counters (uint32, updated in place); h1, h2,
// weights, est: uint32[n_ops]; est filled with 0xFFFFFFFF.  tile_w (a
// multiple of 32), tiles_per_row and grid come from ops/cms_seq.py:_plan.
// Returns the CUDA error of setting the shared-memory limit or of the
// launch (0 on success).
extern "C" int cms_seq_launch(void* table, const void* h1, const void* h2,
                              const void* weights, void* est, int n_ops, int d,
                              int w, int tile_w, int tiles_per_row, int grid,
                              void* stream) {
  const int smem = smem_bytes(tile_w);
  cudaError_t err = cudaFuncSetAttribute(
      cms_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cms_seq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(table), static_cast<const uint32_t*>(h1),
      static_cast<const uint32_t*>(h2), static_cast<const uint32_t*>(weights),
      static_cast<uint32_t*>(est), static_cast<uint32_t>(n_ops), d,
      static_cast<uint32_t>(w), tile_w,
      tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}
