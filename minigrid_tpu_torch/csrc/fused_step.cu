// Fused core-dynamics step + observation for batched MiniGrid envs, on Hopper.
//
// Replaces minigrid_tpu/ops/fused_step.py::_kernel (the Pallas TPU kernel
// launched by fused_rollout). It computes the same function: for each env,
// T steps of the core transition (turn/move, goal reward, lava termination,
// pickup/drop/door toggle/box contents with the grid write, truncation at
// max_steps), and after each step the egocentric V x V window, the
// visibility flood on the raw window, the carried-object overlay and the
// mask to the 9 observation bits (or the see-through-walls mask). A second
// entry takes one broadcast reset row per step (packed grid + scalars): envs
// that finish the step (terminated | truncated) take the row after the
// transition and before the observation, the order of the JAX package's
// envs/base.py::_apply_broadcast_reset. A kernel of its own, the observe
// entry (fused_observe_kernel), is the observation half alone (the JAX
// kernel's view code, core/obs.py::gen_obs in packed mode): it reads each
// env's state and writes its packed view, with no transition and no state
// out. The auto-resets that put a different state into each finished env
// (regenerated, per-env pool rows, the fresh buffer's ranked rows) step
// with the first entry, select in PyTorch, and observe with it. Any odd
// view size 3..63: a view row is one bit mask, 32-bit for V <= 31
// (compiled for V=7 and for V given at run time) and 64-bit for
// 33 <= V <= 63 (V given at run time; the largest grid, 25x25, is covered
// from any cell by a 49-wide view, so wider views add only out-of-grid
// cells).
//
// Design: a group of G lanes per env (G = 1, 2, 4, 8, 16 or 32, a template
// parameter that the wrapper picks per launch from B and the SM count: enough
// lanes per env that a small batch still gives every SM's four schedulers a
// warp each, and no more, since the serial work below is repeated on each of an
// env's lanes), at most 256 threads per block. Work that is parallel across
// cells is spread over the group's lanes: the cell packing, the reset-row copy
// and the window reads. The view is swept row by row from the agent's row up:
// for row j, lane k reads view cells (k, j), (k+G, j), ..., one ballot per G
// cells gives the row's transparency mask, every lane of the group runs the
// row's flood on it (uniform values, no broadcast), and the row's observation
// words follow at once from the row's visibility, so each window cell is read
// once. The flood and the overlay of a row are one device function, view_row,
// that both kernels call; each reads the cells its own way. The flood is the
// two-pass sweep of core/visibility.py on a row packed into one 32- or 64-bit
// mask, each pass one integer add (a carry runs through a run of transparent
// cells; the descending pass works on the bit-reversed row). The loop has no
// branches, so the compiler issues the rows' reads ahead of their floods (the
// step entry keeps its gather inline for that: through a generic row loop its
// 64-bit rows ran 5% slower). The scalar transition also runs on every lane of
// the group, and one lane writes the front cell. The observation words go to
// shared memory, and the warp then writes its envs' words for the step as one
// contiguous run (full 32-byte sectors; scattered 4-byte stores were the first
// design's bottleneck at large B). Nothing synchronises beyond the warp.
//
// Shared memory per env of the step entries: the packed cells (int32, an
// odd row length, so 32 lanes reading the same cell of 32 envs hit 32
// banks; bit 16 caches the cell's transparency), the V*V observation words
// of the current step, and the env's grid bytes as (W, H, 5) uint8. The
// bytes are copied in once, packed by the group, and kept equal to the
// packed cells by every write (the front cell, a reset row), so the state
// goes back out with no unpacking: a step writes at most one cell or one
// reset row. The scalars stay in registers across the T steps, and each
// step's actions come G steps at a time, one per lane, a chunk ahead, and
// are shuffled to the group.
//
// The state copy. Each group once copied its env's grid itself, by 16-byte
// vectors where the grid's size (W*H*5) and both pointers were multiples of
// 16 and byte by byte otherwise: on 124 of the 178 IDs (5x5, 9x9, 19x19,
// 22x22, 25x25, ...) a lane issued hundreds of dependent byte loads, then as
// many stores (~390 each at 25x25, G=8), with one block an SM to hide them:
// 38-47 us of a T=1 launch at 22x22 and 25x25. What bounds the copy is the
// run's bytes, in and out: the grids of a block's envs lie back to back in
// device memory (the wrapper requires contiguous tensors), one run of envs
// x W*H*5 bytes from grid + b0*W*H*5. So the block stages the run as it
// lies, unpadded, at a shared address equal to its device address modulo
// 16, and moves it as Hopper moves bulk data, a warp at a time: the envs of
// a warp are a contiguous part of the run, and lane 0 issues one TMA bulk
// copy (cp.async.bulk) of that part's 16-byte aligned middle on the warp's
// mbarrier, which expects its bytes, the first lanes copy the edges (at
// most 15 bytes at each end), and the warp waits on the barrier. After the
// T steps every lane fences its shared writes for the async proxy, and lane
// 0 issues the bulk copy out, waiting until it has read the shared memory
// before the warp exits. An output whose offset modulo 16 differs from the
// input's (an input that does not start on a 16-byte boundary) goes out as
// whole aligned 16-byte words that each lane shifts together from shared
// words instead. One copy for the whole block, with the block synchronised
// at entry and exit, was as fast on the large grids but 14-18% slower than
// the per-env vectors at a T=1 launch on 16x8 and 16x16 and 3% slower a
// step of the loop (port_probes/kernel_times.py, PERF.md): the warps of a
// block stay apart in time when each waits only for its own envs.
//
// Bound of the step entries: bytes. Per step launch it reads the state
// (B * (W*H*5 + 21) bytes) and writes it back with its two flags
// (B * (W*H*5 + 23)), reads T * B int32 actions and writes
// T * B * (4*V*V + 4 + 2) bytes of observations, rewards and flags. The
// integer work is a few hundred operations per env-step (2 V^2 window
// reads and tests, V rows x 2 ceil(log2 V) Kogge-Stone steps of two
// operations, ~30 for the transition): at B=4096, T=128, DoorKey-8x8 about
// 6.6 us at the H100's INT32 rate against the 33.1 us byte bound.
//
// The observe entry never writes the grid, so it stages none. Its bound is
// bytes too, and needs only each env's window: the window's in-grid cells (5
// bytes each, at most 5 V^2), 17 bytes of scalars and the 4 V^2 bytes of the
// view it writes. At B=4096 and V=7 that is at most 1.9 MB, ~0.56 us at 3.35
// TB/s on any grid, under a launch's own ~2 us: what it pays is latency. So
// each lane of an env's group computes its view cells' world coordinates and
// loads each in-grid cell straight from device memory into registers, as the
// two aligned 32-bit words that hold the cell's 5 bytes (out-of-grid cells
// are the grey wall and load nothing). The cells of the window in one grid
// column form one run of 5 V bytes, whose words and sectors neighbouring
// cells share. A lane reads its own view cells rather than words of those
// runs: a view row is a grid column only where the agent faces along x, so a
// lane reading a run would have to hand most of its words to other lanes, a
// shuffle for each word saved. The loads of every row of a chunk of rows
// (the whole window at V=7 for G >= 4) are issued before the chunk's first
// flood, so one memory latency covers them. A view of 33 or more is mostly
// outside any grid: its sweep stops once no env of the warp passes light on
// to the row above, and the rows left are written as 0. Shared memory holds
// only the view words, for the warp's contiguous store: envs x V*V words a
// block (6,272 B for 32 envs at V=7, on any grid), and the wrapper picks G
// and the envs a block (ops/fused_step.py::observe_launch_geometry) for the
// warps an SM holds.

// Float rule: the reward is 1 - 0.9 * (step_count / max_steps) rounded after
// each operation (__fdiv_rn, __fmul_rn, __fsub_rn, and the build passes
// -fmad=false), so it is bit-identical to the plain PyTorch version.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes (minigrid_tpu_torch/ops/native.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1, kWall = 2, kFloor = 3, kDoor = 4, kKey = 5,
              kBall = 6, kBox = 7, kGoal = 8, kLava = 9;
constexpr int kOpen = 0, kClosed = 1, kLocked = 2;
constexpr int kWallPacked = kWall | (5 << 4);  // grey wall
constexpr int kNScal = 8;  // x, y, dir, carrying, step_count, term, trunc, pad
constexpr int kMaxThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBadLaunch = -1;
constexpr int kMaxNarrowView = 31;  // views up to this take 32-bit rows
constexpr int kMaxView = 63;        // and up to this 64-bit rows
// cells a lane of the observe entry holds in flight: its view cells of a
// chunk of rows, loaded before the chunk's floods
constexpr int kCellsInFlight = 16;

struct Args {
  const uint8_t* grid_in;    // (B, W, H, 5)
  const int32_t* pos_in;     // (B, 2)
  const int32_t* dir_in;     // (B,)
  const uint8_t* carry_in;   // (B, 5)
  const int32_t* step_in;    // (B,)
  const int32_t* actions;    // (T, B)
  const int32_t* reset_grid; // (T, W*H) packed cells, or null
  const int32_t* reset_scal; // (T, kNScal), or null
  int32_t* obs;              // (T, V*V, B) native or (T, B, V*V) public
  float* reward;             // (T, B)
  uint8_t* term;             // (T, B)
  uint8_t* trunc;            // (T, B)
  uint8_t* grid_out;         // (B, W, H, 5)
  int32_t* pos_out;          // (B, 2)
  int32_t* dir_out;          // (B,)
  uint8_t* carry_out;        // (B, 5)
  int32_t* step_out;         // (B,)
  uint8_t* term_out;         // (B,)
  uint8_t* trunc_out;        // (B,)
  int B, T, W, H, V, max_steps, see_through, native_layout;
  int G, envs;  // lanes per env, envs per block
};
constexpr int kStepPointers = 19;

struct ObserveArgs {
  const uint8_t* grid_in;   // (B, W, H, 5)
  const int32_t* pos_in;    // (B, 2)
  const int32_t* dir_in;    // (B,)
  const uint8_t* carry_in;  // (B, 5)
  int32_t* obs;             // (B, V*V)
  int B, W, H, V, see_through;
  int G, envs;  // lanes per env, envs per block
};
constexpr int kObservePointers = 5;

// Shared memory of a block of `envs` envs of the step entries, from the
// start (mirrored by ops/fused_step.py::shared_memory_bytes): the packed
// cells, envs x (NC | 1) words; the observation words of the current step,
// envs x V*V; then, 16-byte aligned, the mbarriers of the state copy (one
// a warp) and the staging of the block's run of grids, envs x 5 NC bytes as
// they lie in device memory, unpadded, placed up to 15 bytes in so that its
// shared and device addresses agree modulo 16, and read up to one word past
// its end by a shifted copy out (kRunSlack).
constexpr int kBarrierBytes = 8 * (kMaxThreads / 32);
constexpr int kRunSlack = 15 + 4;
struct Layout {
  int ncp, obs_off, bar_off, stage_off, bytes;  // obs_off in words
  __host__ __device__ Layout(int nc, int v, int envs)
      : ncp(nc | 1),
        obs_off(envs * ncp),
        bar_off(((obs_off + envs * v * v + 3) & ~3) * 4),
        stage_off(bar_off + kBarrierBytes),
        bytes(stage_off + ((envs * 5 * nc + kRunSlack + 15) & ~15)) {}
};

// Shared memory of a block of the observe entry: the envs' observation
// words, envs x V*V (ops/fused_step.py::observe_shared_memory_bytes).
__host__ __device__ constexpr int observe_smem_bytes(int v, int envs) {
  return envs * v * v * 4;
}

__device__ __forceinline__ int pack5(const uint8_t* c) {
  return c[0] | (c[1] << 4) | (c[2] << 7) | (c[3] << 9) | (c[4] << 13);
}

// A packed cell as the view sweep reads it: bit 16 set when light passes
// (see_behind: not a wall, not a closed or locked door). Out-of-grid reads
// give kWallPacked, which has it clear.
constexpr int kClear = 1 << 16;

__device__ __forceinline__ int with_clear(int p) {
  const int typ = p & 15;
  const bool opaque = (typ == kWall) | ((typ == kDoor) & ((p & 0x180) != 0));
  return (p & 0xFFFF) | (opaque ? 0 : kClear);
}

__device__ __forceinline__ void unpack5(int p, uint8_t* c) {
  c[0] = p & 15;
  c[1] = (p >> 4) & 7;
  c[2] = (p >> 7) & 3;
  c[3] = (p >> 9) & 15;
  c[4] = (p >> 13) & 7;
}

// The state copy of the step entries: a warp's run of grids moved between
// device memory and its staging in shared memory by the Tensor Memory
// Accelerator (TMA), one bulk copy each way for the run's 16-byte aligned
// middle, the edges (at most 15 bytes at each end) by plain loads and
// stores of the first lanes. Each is called by every lane of the warp.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Where a run of n bytes starting at p splits: head bytes up to the first
// 16-byte boundary, then mid bytes of whole 16-byte words, then the tail.
struct RunSplit {
  int head, mid, tail;
  __device__ __forceinline__ RunSplit(const void* p, int n) {
    head = min(n, int(-reinterpret_cast<uintptr_t>(p) & 15));
    mid = (n - head) & ~15;
    tail = n - head - mid;
  }
};

// Byte i < head of the run by lane i, byte head + mid + i < n by lane
// 16 + i.
__device__ __forceinline__ void copy_edges(uint8_t* dst, const uint8_t* src,
                                           RunSplit r) {
  const int t = threadIdx.x & 31;
  if (t < r.head) dst[t] = src[t];
  else if (t >= 16 && t - 16 < r.tail) {
    const int i = r.head + r.mid + t - 16;
    dst[i] = src[i];
  }
}

// The run of n bytes at src (device memory) into dst (shared memory, dst
// and src equal modulo 16): lane 0 initialises the warp's barrier and
// issues the bulk copy of the middle, whose bytes the barrier expects;
// every lane waits for it. Ends with the run in place for every lane.
__device__ __forceinline__ void stage_in(uint8_t* dst, const uint8_t* src,
                                         int n, uint64_t* bar) {
  const RunSplit r(src, n);
  const unsigned b = shared_addr(bar);
  if ((threadIdx.x & 31) == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    // the barrier's initialisation before the async proxy's first use
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (r.mid > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
          "r"(r.mid)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(shared_addr(dst + r.head)),
          "l"(src + r.head), "r"(r.mid), "r"(b)
          : "memory");
    }
  }
  copy_edges(dst, src, r);
  __syncwarp();  // the barrier initialised, the edges written
  if (r.mid > 0) {
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p;\n"
          "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "  selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(b)
          : "memory");
    }
  }
}

// The run of n bytes at src (shared memory) out to dst (device memory),
// after every lane's last write to it. Where the two agree modulo 16 (the
// run came in by stage_in and goes out at the same offset modulo 16: any
// input that starts on a 16-byte boundary) lane 0 issues the bulk copy of
// the middle and waits until it has read the shared memory, before the
// warp exits; otherwise each lane stores whole aligned 16-byte words of the
// middle, each built from the five 32-bit shared words that hold its bytes.
__device__ __forceinline__ void stage_out(uint8_t* dst, const uint8_t* src,
                                          int n) {
  const RunSplit r(dst, n);
  // this lane's writes to the run, before the async proxy reads it
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const unsigned s = shared_addr(src + r.head);  // dst + r.head is aligned
  if ((s & 15) == 0) {
    if (lane == 0 && r.mid > 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              dst + r.head),
          "r"(s), "r"(r.mid)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    copy_edges(dst, src, r);
    if (lane == 0 && r.mid > 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else {
    const unsigned* w =
        reinterpret_cast<const unsigned*>(src + r.head - (s & 3));
    const unsigned shift = (s & 3) * 8;
    uint4* out = reinterpret_cast<uint4*>(dst + r.head);
    for (int k = lane; k < r.mid / 16; k += 32) {
      const unsigned* q = w + 4 * k;
      out[k] = make_uint4(__funnelshift_r(q[0], q[1], shift),
                          __funnelshift_r(q[1], q[2], shift),
                          __funnelshift_r(q[2], q[3], shift),
                          __funnelshift_r(q[3], q[4], shift));
    }
    copy_edges(dst, src, r);
  }
}

// The group's G predicates as bits 0..G-1 (bit k from the group's lane k).
// Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ unsigned group_bits(bool p, int base) {
  if constexpr (G == 1) {
    return p;
  } else {
    const unsigned all = __ballot_sync(kAll, p);
    if constexpr (G == 32) return all;
    else return (all >> base) & ((1u << G) - 1);
  }
}

// A view row as a bit mask: 32 bits for views up to kMaxNarrowView, 64 for
// wider ones, with the bit reversal of its width.
template <bool WIDE>
using Row = std::conditional_t<WIDE, unsigned long long, unsigned>;

__device__ __forceinline__ unsigned brev_row(unsigned v) { return __brev(v); }
__device__ __forceinline__ unsigned long long brev_row(unsigned long long v) {
  return __brevll(v);
}

// Where an env's view lies: view cell (vx, vy) is world (tlx + orx*vx -
// ofx*vy, tly + ory*vx - ofy*vy); out of the grid it reads as a grey wall.
struct Frame {
  int ofx, ofy, orx, ory, tlx, tly;
  __device__ __forceinline__ Frame(int x, int y, int d, int V)
      : ofx((d == 0) - (d == 2)),
        ofy((d == 1) - (d == 3)),
        orx(-ofy),
        ory(ofx),
        tlx(x + ofx * (V - 1) - orx * (V / 2)),
        tly(y + ofy * (V - 1) - ory * (V / 2)) {}
};

// One view row of an env (core/obs.py::gen_obs on row j), the part both
// entries share: from the row's cells (view cell (lg + i*G, j) in u[i]),
// its transparency mask tb (bit vx = view cell (vx, j), from the group's
// ballots) and its seeds, the visibility flood on the raw window, the
// carried-object overlay and the 9-bit mask, written to
// my_obs[vx * V + j]; returns the seeds of the row above.
template <int G, int kIter, bool WIDE>
__device__ __forceinline__ Row<WIDE> view_row(const int (&u)[kIter],
                                              Row<WIDE> tb, Row<WIDE> seed,
                                              int j, int V, Row<WIDE> full,
                                              int carry, int see_through,
                                              int lg, int32_t* my_obs) {
  using RowT = Row<WIDE>;
  constexpr int kRowBits = WIDE ? 64 : 32;
  // pass 1, ascending x: m[i] = seed[i] | (m[i-1] & t[i-1]). A seed runs
  // up through the transparent cells above it: adding its first step `up`
  // to the run's mask P carries through the run and clears it.
  const RowT P = (tb << 1) & full;
  const RowT up = (seed << 1) & P;
  const RowT m1 = seed | up | (P & ~(P + up));
  // pass 2, descending x: m[i] |= m[i+1] & t[i+1], the same on the
  // bit-reversed row
  const int rev = kRowBits - V;
  const RowT rP = ((brev_row(tb) >> rev) << 1) & full;
  const RowT rm = brev_row(m1) >> rev;
  const RowT rup = (rm << 1) & rP;
  const RowT m2 = brev_row(RowT(rm | rup | (rP & ~(rP + rup)))) >> rev;
  // seeds of the row above: a visited transparent cell marks the cell
  // above it and that cell's left/right neighbour
  const RowT e = m1 & tb & (full >> 1);
  const RowT f = m2 & tb & (full ^ 1);
  const RowT above = (e | ((e << 1) & full)) | (f | (f >> 1));
  const RowT m = see_through ? full : m2;
  const int hs = V / 2;
#pragma unroll
  for (int i = 0; i < kIter; ++i) {
    const int vx = i * G + lg;
    if (i * G < V) {
      // carried-object overlay at the agent's cell
      const int c = j == V - 1 && vx == hs ? carry : u[i];
      const int val = (m >> vx) & 1 ? c & 0x1FF : 0;
      if (vx < V) my_obs[vx * V + j] = val;
    }
  }
  return above;
}

// A cell of the observe entry as read from device memory: the two aligned
// 32-bit words that hold its 5 bytes of the (W, H, 5) grid (both hold a
// byte of the grid, so neither leaves its allocation), and its bit offset
// in the first.
struct CellWords {
  unsigned lo, hi, shift;
};

__device__ __forceinline__ CellWords load_cell(const uint8_t* cell) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(cell);
  const unsigned* w = reinterpret_cast<const unsigned*>(p & ~uintptr_t(3));
  return {__ldg(w), __ldg(w + 1), unsigned(p & 3) * 8};
}

// The packed cell, with its transparency bit, of a cell's words.
__device__ __forceinline__ int packed_cell(CellWords r) {
  const unsigned c = __funnelshift_r(r.lo, r.hi, r.shift);  // bytes 0-3
  const unsigned c4 = (r.hi >> r.shift) & 0xff;
  return with_clear((c & 0xff) | ((c >> 8 & 0xff) << 4) |
                    ((c >> 16 & 0xff) << 7) | ((c >> 24) << 9) |
                    (c4 << 13));
}

// The warp's envs' observation words (warp_words of them from warp_obs in
// shared memory, the envs from warp_b on), written by the whole warp after
// a __syncwarp: in the public layout (B, V*V) one contiguous run, in the
// native (V*V, B) one run of the warp's envs per word.
__device__ __forceinline__ void store_view(int32_t* obs, const int32_t* warp_obs,
                                           long long B, long long warp_b,
                                           int warp_words, int VV,
                                           bool native) {
  const int lane = threadIdx.x & 31;
  if (!native) {
    int32_t* dst = obs + warp_b * VV;
#pragma unroll 4
    for (int i = lane; i < warp_words; i += 32) dst[i] = warp_obs[i];
  } else {
    const int ne = warp_words / VV;
    int32_t* dst = obs + warp_b;
#pragma unroll 4
    for (int i = lane; i < warp_words; i += 32) {
      const int k = i / ne, e = i - k * ne;
      dst[(long long)k * B + e] = warp_obs[e * VV + k];
    }
  }
}

// Words of the warp's envs' views: 32 / G envs, fewer in the ragged last
// block.
template <int G>
__device__ __forceinline__ int warp_view_words(long long B, long long warp_b,
                                               int VV) {
  return (int)(B - warp_b < 32 / G ? (B > warp_b ? B - warp_b : 0) : 32 / G) *
         VV;
}

// The step entries: T steps, with or without a reset row each. VC: the view
// size when known at compile time (7, the default), else 0 and the view
// size is a.V. WIDE: the rows are 64-bit (33 <= V <= 63).
template <int G, int VC, bool WIDE, bool RESET>
__global__ void __launch_bounds__(kMaxThreads) fused_step_kernel(Args a) {
  using RowT = Row<WIDE>;
  // view cells (vx, j) of a row j that this lane reads: vx = lg + i*G
  constexpr int kIter =
      ((VC > 0 ? VC : (WIDE ? kMaxView : kMaxNarrowView)) + G - 1) / G;
  extern __shared__ uint4 smem_raw[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem_raw);
  const int V = VC > 0 ? VC : a.V;
  const int hs = V / 2, VV = V * V;
  const RowT full = (RowT(1) << V) - 1;
  const int lg = threadIdx.x & (G - 1);          // lane within the group
  const int base = (threadIdx.x & 31) & ~(G - 1);  // group's first warp lane
  const int slot = threadIdx.x / G;              // env within the block
  const long long B = a.B;
  const long long b0 = (long long)blockIdx.x * a.envs;  // block's first env
  const long long b = b0 + slot;
  // Lanes of envs past B (the ragged last block) run every step on a
  // dummy state, for the warp collectives, and touch no device memory.
  const bool active = b < B;
  const int W = a.W, H = a.H, NC = W * H, RB = NC * 5;
  const Layout L(NC, V, a.envs);
  int32_t* g = smem + slot * L.ncp;  // packed cell c at g[c], x-major
  // the warp's envs' observation words, in the order of the public layout
  const int warp_slot = (threadIdx.x & ~31) / G;  // first env of the warp
  int32_t* warp_obs = smem + L.obs_off + warp_slot * VV;
  int32_t* my_obs = smem + L.obs_off + slot * VV;
  const long long warp_b = b0 + warp_slot;
  const int warp_words = warp_view_words<G>(B, warp_b, VV);
  // The grids of the block's envs below B lie back to back in device
  // memory, from grid_in + b0 * RB: staged as they lie, at the run's offset
  // modulo 16, each warp copies its own envs' part of that run.
  const int run = (int)(B - b0 < a.envs ? B - b0 : a.envs) * RB;
  const int w0 = min(run, warp_slot * RB);
  const int w1 = min(run, w0 + 32 / G * RB);
  uint8_t* smem_bytes = reinterpret_cast<uint8_t*>(smem_raw);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem_bytes + L.bar_off) + threadIdx.x / 32;
  uint8_t* stage = smem_bytes + L.stage_off +
                   (reinterpret_cast<uintptr_t>(a.grid_in + b0 * RB) & 15);
  uint8_t* bytes = stage + slot * RB;

  // --- state in ----------------------------------------------------------
  int x = 0, y = 0, d = 0, carry = kEmpty, sc = 0, te = 0, tr = 0;
  if (active) {
    x = a.pos_in[2 * b];
    y = a.pos_in[2 * b + 1];
    d = a.dir_in[b];
    carry = pack5(a.carry_in + 5 * b);
    sc = a.step_in[b];
  }
  stage_in(stage + w0, a.grid_in + b0 * RB + w0, w1 - w0, bar);
  for (int c = lg; c < NC; c += G) g[c] = with_clear(pack5(bytes + 5 * c));
  __syncwarp();

  // actions: lane k holds step t0 + k of the current chunk of G steps; the
  // next chunk is loaded while this one is used
  const int32_t* actions = a.actions;
  const int T = a.T;
  auto load_actions = [&](int t0) {
    const int t = t0 + lg;
    return active && t < T ? actions[(long long)t * B + b] : 0;
  };
  int acts = load_actions(0), next_acts = load_actions(G);

  for (int t = 0; t < T; ++t) {
    const int tk = t & (G - 1);
    if (t > 0 && tk == 0) {
      acts = next_acts;
      next_acts = load_actions(t + G);
    }
    const int act = G == 1 ? acts : __shfl_sync(kAll, acts, tk, G);
    sc += 1;
    // --- transition (core/step.py::step_core), on every lane ------------
    const int turn = act == 0 ? -1 : (act == 1 ? 1 : 0);
    const int nd = (d + turn + 4) & 3;
    const int fx = (d == 0) - (d == 2), fy = (d == 1) - (d == 3);
    const int fwx = x + fx, fwy = y + fy;
    const bool inb = fwx >= 0 && fwx < W && fwy >= 0 && fwy < H;
    const int fidx = fwx * H + fwy;
    const int fval = inb ? g[fidx] : kWallPacked;  // before write
    const int ftype = fval & 15, fcolor = (fval >> 4) & 7,
              fstate = (fval >> 7) & 3;
    const bool carrying = (carry & 15) != kEmpty;
    const bool can_overlap = ftype == kEmpty || ftype == kFloor ||
                             ftype == kGoal || ftype == kLava ||
                             (ftype == kDoor && fstate == kOpen);
    const bool fwd = act == 2;
    const bool move = fwd && can_overlap && inb;
    const bool hits_goal = fwd && ftype == kGoal;
    const bool terminated = hits_goal || (fwd && ftype == kLava);
    const float rew =
        hits_goal ? __fsub_rn(1.0f, __fmul_rn(0.9f, __fdiv_rn(
                                                  (float)sc,
                                                  (float)a.max_steps)))
                  : 0.0f;
    const bool do_pickup = act == 3 && !carrying &&
                           (ftype == kKey || ftype == kBall || ftype == kBox);
    const bool do_drop = act == 4 && ftype == kEmpty && carrying;
    const bool is_toggle = act == 5;
    const bool is_door = ftype == kDoor, is_box = ftype == kBox;
    const bool has_key =
        (carry & 15) == kKey && ((carry >> 4) & 7) == fcolor;
    const int toggled = fstate == kLocked
                            ? (has_key ? kOpen : kLocked)
                            : (fstate == kOpen ? kClosed : kOpen);
    const int door_cell = (fval & ~(3 << 7)) | (toggled << 7);
    const int cont_type = (fval >> 9) & 15, cont_color = (fval >> 13) & 7;
    const int contents =
        cont_type != 0 ? (cont_type | (cont_color << 4)) : kEmpty;
    int new_fwd = fval;
    if (do_pickup) new_fwd = kEmpty;
    if (do_drop) new_fwd = carry;
    if (is_toggle && is_door) new_fwd = door_cell;
    if (is_toggle && is_box) new_fwd = contents;
    const bool writes =
        inb && (do_pickup || do_drop || (is_toggle && (is_door || is_box)));
    carry = do_pickup ? fval : (do_drop ? kEmpty : carry);
    if (move) { x = fwx; y = fwy; }
    d = nd;
    te = terminated;
    tr = sc >= a.max_steps;
    const bool done = te || tr;
    if (active && lg == 0) {
      const long long o = (long long)t * B + b;
      a.reward[o] = rew;
      a.term[o] = te;
      a.trunc[o] = tr;
    }
    __syncwarp();  // the group has read the front cell and the last window
    // a reset row replaces the whole grid, the front cell included
    if (writes && lg == 0 && !(RESET && done)) {
      g[fidx] = with_clear(new_fwd);
      unpack5(new_fwd, bytes + 5 * fidx);
    }

    // --- broadcast reset row into finished envs, before the obs --------
    if (RESET && done) {
      const int32_t* rg = a.reset_grid + (long long)t * NC;
      for (int c = lg; c < NC; c += G) {
        const int p = rg[c];
        g[c] = with_clear(p);
        unpack5(p, bytes + 5 * c);
      }
      const int32_t* rs = a.reset_scal + (long long)t * kNScal;
      x = rs[0]; y = rs[1]; d = rs[2]; carry = rs[3]; sc = rs[4];
      te = rs[5]; tr = rs[6];
    }
    __syncwarp();

    // --- observation on the new state (core/obs.py::gen_obs) -----------
    // Rows j from the agent's row up: the lanes read the row's cells, one
    // ballot per G cells gives the row's transparency mask, and view_row
    // floods it on every lane and writes the row's words. No branches, so
    // the unrolled rows' reads go ahead of the floods.
    const Frame f(x, y, d, V);
    RowT seed = RowT(1) << hs;
#pragma unroll
    for (int j = V - 1; j >= 0; --j) {
      const int rx = f.tlx - f.ofx * j, ry = f.tly - f.ofy * j;  // (0, j)
      int u[kIter];
      RowT tb = 0;
#pragma unroll
      for (int i = 0; i < kIter; ++i) {
        if (i * G < V) {
          const int vx = i * G + lg;
          const int wx = rx + f.orx * vx, wy = ry + f.ory * vx;
          const bool in = vx < V && (unsigned)wx < (unsigned)W &&
                          (unsigned)wy < (unsigned)H;
          int c = kWallPacked;  // out of the grid: a grey wall
          if (in) c = g[wx * H + wy];
          u[i] = c;
          tb |= RowT(group_bits<G>(c & kClear, base)) << (i * G);
        }
      }
      seed = view_row<G, kIter, WIDE>(u, tb, seed, j, V, full, carry,
                                      a.see_through, lg, my_obs);
    }
    __syncwarp();
    store_view(a.obs + (a.native_layout ? (long long)t * VV * B
                                        : (long long)t * B * VV),
               warp_obs, B, warp_b, warp_words, VV, a.native_layout);
  }

  // --- state out: the grid bytes were kept current -----------------------
  stage_out(a.grid_out + b0 * RB + w0, stage + w0, w1 - w0);
  if (active && lg == 0) {
    a.pos_out[2 * b] = x;
    a.pos_out[2 * b + 1] = y;
    a.dir_out[b] = d;
    unpack5(carry, a.carry_out + 5 * b);
    a.step_out[b] = sc;
    a.term_out[b] = te;
    a.trunc_out[b] = tr;
  }
}

// The observe entry: each env's view of its state as given, its window's
// cells read from device memory (the source note above).
template <int G, int VC, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads)
    fused_observe_kernel(ObserveArgs a) {
  using RowT = Row<WIDE>;
  constexpr int kMaxV = VC > 0 ? VC : (WIDE ? kMaxView : kMaxNarrowView);
  // view cells (vx, j) of a row j that this lane reads: vx = lg + i*G
  constexpr int kIter = (kMaxV + G - 1) / G;
  // rows whose reads go out together: kCellsInFlight cells a lane
  constexpr int kRows = kCellsInFlight / kIter < 1 ? 1
                        : kCellsInFlight / kIter > kMaxV
                            ? kMaxV
                            : kCellsInFlight / kIter;
  extern __shared__ uint4 smem_raw[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem_raw);
  const int V = VC > 0 ? VC : a.V;
  const int hs = V / 2, VV = V * V;
  const RowT full = (RowT(1) << V) - 1;
  const int lg = threadIdx.x & (G - 1);
  const int base = (threadIdx.x & 31) & ~(G - 1);
  const int slot = threadIdx.x / G;
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * a.envs + slot;
  // Lanes of envs past B (the ragged last block) sweep a dummy state with
  // no grid (W = 0: every cell a wall), for the warp collectives, and
  // touch no device memory.
  const bool active = b < B;
  const int W = active ? a.W : 0, H = a.H;
  int x = 0, y = 0, d = 0, carry = kEmpty;
  if (active) {
    x = a.pos_in[2 * b];
    y = a.pos_in[2 * b + 1];
    d = a.dir_in[b];
    carry = pack5(a.carry_in + 5 * b);
  }
  const uint8_t* grid = a.grid_in + (active ? b : 0) * (long long)(W * H * 5);
  int32_t* my_obs = smem + slot * VV;
  const Frame f(x, y, d, V);
  RowT seed = RowT(1) << hs;
#pragma unroll
  for (int j0 = V - 1; j0 >= 0; j0 -= kRows) {
    // every read of kRows rows first, so one memory latency covers them
    CellWords raw[kRows][kIter];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 - r;
      const int rx = f.tlx - f.ofx * j, ry = f.tly - f.ofy * j;  // (0, j)
#pragma unroll
      for (int i = 0; i < kIter; ++i) {
        const int vx = i * G + lg;
        const int wx = rx + f.orx * vx, wy = ry + f.ory * vx;
        const bool in = j >= 0 && i * G < V && vx < V &&
                        (unsigned)wx < (unsigned)W &&
                        (unsigned)wy < (unsigned)H;
        raw[r][i] = {0x0502u, 0u, 0u};  // a grey wall's bytes (2, 5, 0, ...)
        if (in) raw[r][i] = load_cell(grid + 5 * (wx * H + wy));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 - r;
      if (j < 0) break;  // the last chunk's rows past row 0
      int u[kIter];
      RowT tb = 0;
#pragma unroll
      for (int i = 0; i < kIter; ++i) {
        if (i * G < V) {
          u[i] = packed_cell(raw[r][i]);
          tb |= RowT(group_bits<G>(u[i] & kClear, base)) << (i * G);
        }
      }
      seed = view_row<G, kIter, WIDE>(u, tb, seed, j, V, full, carry,
                                      a.see_through, lg, my_obs);
      // A view of 33 or more is mostly outside any grid: once no env of
      // the warp passes light on (walls not see-through), every row above
      // is unseen, and its words are 0.
      if constexpr (WIDE) {
        if (!a.see_through && !__any_sync(kAll, seed != 0)) {
          for (int k = j - 1; k >= 0; --k) {
#pragma unroll
            for (int i = 0; i < kIter; ++i) {
              const int vx = i * G + lg;
              if (i * G < V && vx < V) my_obs[vx * V + k] = 0;
            }
          }
          j0 = -1;  // ends the sweep
          break;
        }
      }
    }
  }
  const int warp_slot = (threadIdx.x & ~31) / G;
  const long long warp_b = (long long)blockIdx.x * a.envs + warp_slot;
  __syncwarp();
  store_view(a.obs, smem + warp_slot * VV, B, warp_b,
             warp_view_words<G>(B, warp_b, VV), VV, false);
}

// Opts a kernel into `bytes` of dynamic shared memory where that is above
// the default 48 KB, then launches it and returns the CUDA error.
template <typename Kernel, typename A>
int launch(Kernel kernel, const A& a, int G, int bytes, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.B + a.envs - 1) / a.envs;
  kernel<<<blocks, a.envs * G, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool RESET>
struct StepLaunch {
  const Args& a;
  cudaStream_t s;
  template <int G, int VC, bool WIDE>
  int go() const {
    return launch(fused_step_kernel<G, VC, WIDE, RESET>, a, G,
                  Layout(a.W * a.H, a.V, a.envs).bytes, s);
  }
};

struct ObserveLaunch {
  const ObserveArgs& a;
  cudaStream_t s;
  template <int G, int VC, bool WIDE>
  int go() const {
    return launch(fused_observe_kernel<G, VC, WIDE>, a, G,
                  observe_smem_bytes(a.V, a.envs), s);
  }
};

// l.go<G, VC, WIDE>() for the instantiation of G lanes and view size V
template <int G, typename L>
int by_view(const L& l, int V) {
  if (V == 7) return l.template go<G, 7, false>();
  if (V <= kMaxNarrowView) return l.template go<G, 0, false>();
  return l.template go<G, 0, true>();
}

template <typename L>
int dispatch(const L& l, int G, int V) {
  switch (G) {
    case 1: return by_view<1>(l, V);
    case 2: return by_view<2>(l, V);
    case 4: return by_view<4>(l, V);
    case 8: return by_view<8>(l, V);
    case 16: return by_view<16>(l, V);
    case 32: return by_view<32>(l, V);
    default: return kBadLaunch;
  }
}

bool bad_geometry(int view_size, int group_lanes, int envs_per_block) {
  const int threads = envs_per_block * group_lanes;
  return view_size < 3 || view_size > kMaxView || view_size % 2 == 0 ||
         envs_per_block < 1 || threads % 32 != 0 || threads > kMaxThreads;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0, -1 for a view size or launch
// geometry the kernel does not take (view size odd 3..63; G lanes per env
// a power of two up to 32; envs_per_block * G a multiple of 32, at most
// 256), or the CUDA error of the launch. Shared memory above 48 KB per
// block is opted into (up to the card's limit). `pointers` is a host array
// of kStepPointers device pointers in Args' order; reset_grid and
// reset_scal are both null for no reset row.
int fused_step_launch(const void* const* pointers, int B, int T, int W,
                      int H, int view_size, int max_steps, int see_through,
                      int native_layout, int group_lanes, int envs_per_block,
                      void* stream) {
  if (bad_geometry(view_size, group_lanes, envs_per_block)) return kBadLaunch;
  static_assert(offsetof(Args, B) == sizeof(void*) * kStepPointers,
                "the pointer table and Args disagree");
  Args a;
  std::memcpy(&a, pointers, sizeof(void*) * kStepPointers);
  a.B = B; a.T = T; a.W = W; a.H = H; a.V = view_size;
  a.max_steps = max_steps;
  a.see_through = see_through; a.native_layout = native_layout;
  a.G = group_lanes; a.envs = envs_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.reset_grid != nullptr
             ? dispatch(StepLaunch<true>{a, s}, group_lanes, view_size)
             : dispatch(StepLaunch<false>{a, s}, group_lanes, view_size);
}

// The observation of each env's state as given: obs (B, V*V) int32 in the
// public layout, the same words the step entry writes for a step. Same
// return codes and geometry rules as fused_step_launch; its shared memory
// is envs_per_block * V*V * 4 bytes. `pointers` is a host array of
// kObservePointers device pointers in ObserveArgs' order.
int fused_observe_launch(const void* const* pointers, int B, int W, int H,
                         int view_size, int see_through, int group_lanes,
                         int envs_per_block, void* stream) {
  if (bad_geometry(view_size, group_lanes, envs_per_block)) return kBadLaunch;
  static_assert(offsetof(ObserveArgs, B) == sizeof(void*) * kObservePointers,
                "the pointer table and ObserveArgs disagree");
  ObserveArgs a;
  std::memcpy(&a, pointers, sizeof(void*) * kObservePointers);
  a.B = B; a.W = W; a.H = H; a.V = view_size;
  a.see_through = see_through;
  a.G = group_lanes; a.envs = envs_per_block;
  return dispatch(ObserveLaunch{a, static_cast<cudaStream_t>(stream)},
                  group_lanes, view_size);
}

const char* fused_step_error_string(int code) {
  return code == kBadLaunch
             ? "unsupported view size or launch geometry"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
