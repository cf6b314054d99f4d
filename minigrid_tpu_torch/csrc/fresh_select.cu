// The fresh reset's routing and select on Hopper: each env that finished
// this step takes its row of the fresh buffer, in one launch a step.
//
// Replaces no TPU kernel: the JAX package's fresh select
// (minigrid_tpu/envs/base.py::_fresh_select) is jnp under jit, which XLA
// fuses into one program. In eager PyTorch the same code
// (minigrid_tpu_torch/envs/base.py::fresh_candidates and
// select_reset_states, its plain version) is a cumsum, clamps, one gather
// and one where per state field: ~36 launches a DoorKey step and ~75 a
// BabyAI level's, each a few microseconds of host. This kernel computes all
// of it.
//
// The routing. Env b's rank is `offset` (the finishers of the blocks of a
// global batch before this one, 0 for a whole batch) plus the finishers
// before it; it takes buffer row start + min(rank, window - 1), with start
// = min(cursor, n_buf - window). A block holds kEnvsPerBlock envs. Its
// threads first count the done bytes before its envs (every block recounts
// them: at B=4096 at most 4 KB, from L2), then its first warp ranks its
// envs with one ballot: no second launch and no host sync. The finishers'
// ranks are offset, ..., offset + n - 1, so the overflow count (finishers
// whose rank lies past the window, or whose row the clamped window start
// handed out before) has a closed form, which the last block writes with
// the new cursor, cursor + total.
//
// The select. Every field of the state is a byte row per env, so a block's
// output of a field is one contiguous span of its envs' rows, and so is the
// stepped state's. The block cuts every field's span into 16-byte units and
// numbers them all in one range, field after field, so that a thread has
// kUnroll units in flight whichever fields they belong to: a loop field by
// field would wait one memory latency a field (a first design did: 18 us
// at DoorKey-8x8 B=4096, 71 us at BossLevel's 28 fields). A unit is copied
// whole from the stepped state, except a unit that touches the row of a
// finished env (or lies in a span off a 16-byte boundary): it is assembled
// byte by byte, its 16 loads issued together, from the buffer row for a
// finished env's bytes; the rng field's takes keys ^ salt there instead.
// The field table (each field's bytes a row and the offset of its rows) is
// the packed buffer's header (ops/fresh_select.py::PackedBuffer), so one
// kernel serves every family's state, `extra` included.
//
// Bound: bytes. Each field of the state is read once and written once, and
// a finished env's buffer row read once: 2 x 735 bytes an env at
// DoorKey-8x8 (6.0 MB at B=4096, 1.8 us at 3.35 TB/s) and 2 x 4,427 at
// BossLevel's 22x22 (36.3 MB, 10.8 us). The routing reads B done bytes a
// block from L2.
//
// A library of its own with a plain C interface, built and loaded with
// ctypes through ops/native.py (ops/fresh_select.py::LIBRARY).

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 48;     // ops/fresh_select.py MAX_FIELDS
constexpr int kEnvsPerBlock = 16;  // ranked by one ballot; 2 blocks an SM
                                   // at B=4096 (a multiple of 16: every
                                   // span starts on a 16-byte boundary)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;         // 16-byte units a thread has in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBadLaunch = -1;

// The pointer table's order: ops/fresh_select.py::fresh_select_cuda.
struct SelectArgs {
  // the packed buffer: int64 (bytes a row, byte offset of the rows) per
  // field, then the fields' rows
  const long long* buffer;
  const int32_t* keys;     // (B, 2) the step keys
  const uint8_t* done;     // (B,) bool
  const int32_t* cursor;   // ()
  const int32_t* offset;   // () or null: 0
  const int32_t* total;    // () or null: the batch's finishers
  int32_t* overflow;       // ()
  int32_t* new_cursor;     // ()
  const uint8_t* state[kMaxFields];  // the stepped state's fields (B, ...)
  uint8_t* out[kMaxFields];          // the selected state's fields
  int B, n_buf, window, fields, rng_field, salt0, salt1;
};
constexpr int kPointers = 104;
static_assert(kPointers == 8 + 2 * kMaxFields,
              "the pointer table holds 8 pointers and two per field");

// A field's rows of the block's envs.
struct Span {
  const uint8_t* src;  // the stepped state's
  uint8_t* dst;        // the selected state's
  const uint8_t* buf;  // the field's rows in the buffer
  unsigned rb;         // bytes a row
  unsigned span;       // bytes of the block's rows
  bool aligned;        // src and dst on 16-byte boundaries
};

// Whether unit u (bytes 16u .. 16u + 15 of the span) lies whole in the span
// and in rows of envs that did not finish (`done`: a bit an env of the
// block).
__device__ __forceinline__ bool plain_unit(unsigned u, const Span& s,
                                           unsigned done) {
  const unsigned lo = 16 * u, hi = lo + 15;
  if (!s.aligned || hi >= s.span) return false;
  if (!done) return true;
  const unsigned first = lo / s.rb, last = hi / s.rb;  // last - first < 16
  return ((done >> first) & ((2u << (last - first)) - 1)) == 0;
}

// Unit u byte by byte: a finished env's bytes from its buffer row (`rows`:
// the block's rows by env), the others' from the state; the 16 loads first,
// then the stores (one 16-byte store where the unit allows).
__device__ __forceinline__ void copy_unit_bytes(unsigned u, const Span& s,
                                                unsigned done,
                                                const int* rows) {
  const unsigned lo = 16 * u;
  unsigned e = lo / s.rb, off = lo - e * s.rb;
  uint8_t v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    v[j] = 0;
    if (lo + j < s.span)
      v[j] = __ldg((done >> e) & 1 ? s.buf + (long long)rows[e] * s.rb + off
                                   : s.src + lo + j);
    if (++off == s.rb) off = 0, ++e;
  }
  if (s.aligned && lo + 16 <= s.span) {
    uint4 w;
    w.x = v[0] | v[1] << 8 | v[2] << 16 | (unsigned)v[3] << 24;
    w.y = v[4] | v[5] << 8 | v[6] << 16 | (unsigned)v[7] << 24;
    w.z = v[8] | v[9] << 8 | v[10] << 16 | (unsigned)v[11] << 24;
    w.w = v[12] | v[13] << 8 | v[14] << 16 | (unsigned)v[15] << 24;
    reinterpret_cast<uint4*>(s.dst)[u] = w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (lo + j < s.span) s.dst[lo + j] = v[j];
}

// Unit u of the rng field, int32 (B, 2): keys ^ salt in finished envs.
__device__ __forceinline__ void rng_unit(unsigned u, const Span& s,
                                         unsigned done, const int32_t* keys,
                                         int salt0, int salt1) {
  const int32_t* src = reinterpret_cast<const int32_t*>(s.src);
  int32_t* dst = reinterpret_cast<int32_t*>(s.dst);
  const unsigned words = s.span / 4;
  int32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned w = 4 * u + j;
    v[j] = 0;
    if (w < words)
      v[j] = (done >> (w >> 1)) & 1
                 ? __ldg(keys + w) ^ (w & 1 ? salt1 : salt0)
                 : __ldg(src + w);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * u + j < words) dst[4 * u + j] = v[j];
}

// The field of the block's unit g: the last f with first[f] <= g.
__device__ __forceinline__ int field_of(unsigned g, const unsigned* first,
                                        int fields) {
  int lo = 0, hi = fields - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= g) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    fresh_select_kernel(const __grid_constant__ SelectArgs a) {
  __shared__ int s_count[kWarps];
  __shared__ int s_rows[kEnvsPerBlock];  // a finished env's buffer row
  __shared__ unsigned s_done;
  __shared__ Span s_spans[kMaxFields];
  __shared__ unsigned s_first[kMaxFields + 1];  // a field's first unit
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long e0 = (long long)blockIdx.x * kEnvsPerBlock;
  const int n_env = (int)min((long long)kEnvsPerBlock, a.B - e0);

  // the finishers of the envs before the block's (e0 is a multiple of 4)
  int count = 0;
  if ((reinterpret_cast<uintptr_t>(a.done) & 3) == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(a.done);
    for (long long i = tid; i < e0 / 4; i += kThreads)
      count += __popc(__ldg(words + i) & 0x01010101u);
  } else {
    for (long long i = tid; i < e0; i += kThreads)
      count += __ldg(a.done + i) != 0;
  }
  for (int s = 16; s > 0; s >>= 1) count += __shfl_down_sync(kFull, count, s);
  if (lane == 0) s_count[warp] = count;
  // each field's span, one thread a field
  if (tid < a.fields) {
    const unsigned rb = (unsigned)__ldg(a.buffer + 2 * tid);
    Span s;
    s.src = a.state[tid] + e0 * rb;
    s.dst = a.out[tid] + e0 * rb;
    s.buf = reinterpret_cast<const uint8_t*>(a.buffer) +
            __ldg(a.buffer + 2 * tid + 1);
    s.rb = rb;
    s.span = n_env * rb;
    s.aligned = ((reinterpret_cast<uintptr_t>(s.src) |
                  reinterpret_cast<uintptr_t>(s.dst)) & 15) == 0;
    s_spans[tid] = s;
  }
  __syncthreads();
  if (warp == 0) {
    int before = lane < kWarps ? s_count[lane] : 0;
    for (int s = 16; s > 0; s >>= 1)
      before += __shfl_down_sync(kFull, before, s);
    before = __shfl_sync(kFull, before, 0);
    const bool d = lane < n_env && __ldg(a.done + e0 + lane) != 0;
    const unsigned mask = __ballot_sync(kFull, d);
    const int cursor = __ldg(a.cursor);
    const int offset = a.offset ? __ldg(a.offset) : 0;
    const int rank = offset + before + __popc(mask & ((1u << lane) - 1));
    const int start = min(cursor, a.n_buf - a.window);
    // a cursor and an offset are never negative; the clamp keeps the read
    // inside the buffer whatever they hold
    if (lane < kEnvsPerBlock)
      s_rows[lane] = max(start + min(rank, a.window - 1), 0);
    if (lane == 0) {
      s_done = mask;
      unsigned units = 0;
      for (int f = 0; f < a.fields; ++f) {
        s_first[f] = units;
        units += (s_spans[f].span + 15) / 16;
      }
      s_first[a.fields] = units;
    }
    if (lane == 0 && blockIdx.x == gridDim.x - 1) {
      const int n = before + __popc(mask);  // the batch's finishers
      const int low = min(max(cursor - (a.n_buf - a.window), 0), a.window);
      const int reused = max(0, min(offset + n, low) - offset);
      const int past = max(0, offset + n - max(offset, a.window));
      *a.overflow = reused + past;
      *a.new_cursor = cursor + (a.total ? __ldg(a.total) : n);
    }
  }
  __syncthreads();
  const unsigned done = s_done, units = s_first[a.fields];
  const int32_t* keys = a.keys + 2 * e0;

  for (unsigned g0 = tid; g0 < units; g0 += kThreads * kUnroll) {
    int field[kUnroll];
    unsigned unit[kUnroll];
    bool plain[kUnroll];
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned g = g0 + k * kThreads;
      field[k] = -1;
      plain[k] = false;
      if (g < units) {
        const int f = field_of(g, s_first, a.fields);
        field[k] = f;
        unit[k] = g - s_first[f];
        plain[k] = plain_unit(unit[k], s_spans[f], done);
        if (plain[k])
          v[k] = __ldg(reinterpret_cast<const uint4*>(s_spans[f].src) +
                       unit[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (plain[k])
        reinterpret_cast<uint4*>(s_spans[field[k]].dst)[unit[k]] = v[k];
      else if (field[k] == a.rng_field)
        rng_unit(unit[k], s_spans[field[k]], done, keys, a.salt0, a.salt1);
      else if (field[k] >= 0)
        copy_unit_bytes(unit[k], s_spans[field[k]], done, s_rows);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0, -1 for arguments the kernel does not
// take (B >= 1, 1 <= window <= n_buf, 1 <= fields <= kMaxFields, rng_field
// one of them), or the CUDA error of the launch. `pointers` is a host array
// of kPointers device pointers in SelectArgs' order (the unused field slots
// null); salt0 and salt1 are RESET_RNG_SALT's two words.
int fresh_select_launch(const void* const* pointers, int B, int n_buf,
                        int window, int fields, int rng_field, int salt0,
                        int salt1, void* stream) {
  if (B < 1 || window < 1 || window > n_buf || fields < 1 ||
      fields > kMaxFields || rng_field < 0 || rng_field >= fields)
    return kBadLaunch;
  static_assert(offsetof(SelectArgs, B) == sizeof(void*) * kPointers,
                "the pointer table and SelectArgs disagree");
  SelectArgs a;
  std::memcpy(&a, pointers, sizeof(void*) * kPointers);
  a.B = B; a.n_buf = n_buf; a.window = window; a.fields = fields;
  a.rng_field = rng_field; a.salt0 = salt0; a.salt1 = salt1;
  const int blocks = (B + kEnvsPerBlock - 1) / kEnvsPerBlock;
  fresh_select_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* fresh_select_error_string(int code) {
  return code == kBadLaunch
             ? "unsupported arguments"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
