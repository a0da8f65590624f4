// Sense + pack: R float32 Vth rows, read through slot tables -> (R, C/32)
// packed words.
//
// Replaces src/repro/kernels/mlc_sense.py:mlc_sense (_sense_kernel). Bound by
// memory: 4 B read per cell, 1/8 B written. One thread per output word; a
// block covers kBlock words of one output row, whose address its first thread
// looks up in the tables (the output rows are the tables' rows in order).
//
// Sense + count (mcf_sense_popcount): the same R rows, in the same order, to
// one int, the cells among the first `valid` (row after row) that sense to 1.
// It stands for mlc_sense then a masked popcount_rows of a counted root whose
// plan is one sense: 4 B read per counted cell and nothing else, no word
// written or read back, no mask read. A count needs no lane-major packing, so
// each thread streams 16-byte loads of consecutive cells and adds its bits;
// a grid of the blocks the card holds at once strides over 4096-cell units.
//
// Sense + drain (mcf_mlc_sense_drain): the same R rows to the same words,
// sensed a chunk of rows at a time, each chunk's words copied to pinned host
// memory on a second stream as soon as the chunk is written, so a chunk's
// copy runs while the next is sensed. The launches, events and copies of all
// chunks are enqueued by one call: the host pays for one call, not one per
// chunk. A chunk that holds bits past the result's end is ANDed with the
// tail mask as its words are written, in the same launch.
//
// Sense under several plans (mcf_mlc_sense_multi): the same R rows to P <=
// kMaxPlans word sets, one a read plan, each laid out as mlc_sense's words.
// It replaces no TPU kernel: the JAX package runs mlc_sense once a read plan,
// and so re-reads a pair row under each plan its queries sense it with (a
// range query senses one die's pair under two to five plans). Here each
// cell's Vth is loaded from HBM once and sensed under every plan, so its
// least time is R * C * (4 + P / 8) B over the memory rate, where P
// mlc_sense launches take R * C * P * (4 + 1 / 8) B. A thread owns
// kMultiVec consecutive words of a tile: cells k*128 + w .. w+kMultiVec-1
// are consecutive, so each of its 32 loads is one 16-byte load, and a warp
// reads 512 contiguous bytes. It keeps the 32 * kMultiVec cells in
// registers and, plan after plan, senses them and stores its kMultiVec
// words of that plan with one 16-byte store. The plans (kind, references,
// inversion) travel by value and are copied to shared memory, which a
// plan's loop reads with a runtime index. It takes the MLC kinds (lsb,
// msb, sbr), each plan with its own references and inversion; parity
// reads go through mlc_sense.
#include "sense.cuh"

namespace mcf {

// Where a launch writes: output rows from `row0` on (a chunk of the rows, or
// all of them), and with `mask` the words of rows from `mask_row` on ANDed
// with the mask's words at the same offsets.
struct Span {
  int64_t row0;
  const uint32_t* mask;
  int64_t mask_row;
};

template <int KIND, int NREFS = kMaxRefs>
__global__ void __launch_bounds__(kBlock)
mlc_sense_kernel(const RowTables tables, int n_tables,
                 uint32_t* __restrict__ out, int64_t words,
                 int64_t blocks_per_row, Span span, Refs refs, int n_refs,
                 int invert) {
  __shared__ const float* src;
  const int64_t row = span.row0 + blockIdx.x / blocks_per_row;
  const int64_t wcol = (blockIdx.x % blocks_per_row) * kBlock + threadIdx.x;
  if (threadIdx.x == 0) {
    int i = 0;
    while (i + 1 < n_tables && row >= tables.end[i]) ++i;
    src = table_row(tables, i, row - (i ? tables.end[i - 1] : 0),
                    words * kWordBits);
  }
  __syncthreads();
  if (wcol >= words) return;
  uint32_t word = sense_word<KIND, NREFS>(src, wcol / kLanes,
                                          static_cast<int>(wcol % kLanes),
                                          refs, n_refs, invert != 0);
  if (span.mask != nullptr && row >= span.mask_row)
    word &= __ldg(span.mask + row * words + wcol);
  out[row * words + wcol] = word;
}

// Launch the instance of `kind` over output rows [span.row0, span.row0 + rows).
inline cudaError_t launch_mlc_sense(const RowTables& tables, int n_tables,
                                    uint32_t* out, const Span& span, int64_t rows,
                                    int64_t cols, int kind, const Refs& refs,
                                    int n_refs, int invert,
                                    cudaStream_t stream) {
  const int64_t words = cols / kWordBits;
  const int64_t blocks_per_row = (words + kBlock - 1) / kBlock;
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  switch (kind) {
    case kLsb:
      mlc_sense_kernel<kLsb><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, span, refs, n_refs, invert);
      break;
    case kMsb:
      mlc_sense_kernel<kMsb><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, span, refs, n_refs, invert);
      break;
    case kSbr:
      mlc_sense_kernel<kSbr><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, span, refs, n_refs, invert);
      break;
    case kParity:
      // TLC's AND3 and the reduced-MLC AND read one reference, TLC's OR3
      // two: their launches compare each cell that often, not kMaxRefs times
      if (n_refs == 1)
        mlc_sense_kernel<kParity, 1><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, span, refs, n_refs, invert);
      else if (n_refs == 2)
        mlc_sense_kernel<kParity, 2><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, span, refs, n_refs, invert);
      else
        mlc_sense_kernel<kParity><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, span, refs, n_refs, invert);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// A counting unit: the 4096 cells of one tile of one row, kCountVecs float4
// loads a thread, all issued before the first compare.
constexpr int kCountVecs = kTileCols / (4 * kBlock);

// The cells of one unit, from `p` (this thread's first float4), that sense to
// 1; with TAIL only those of the unit's first `left` cells.
template <int KIND, int NREFS, bool TAIL>
__device__ __forceinline__ int count_unit(const float4* __restrict__ p,
                                          const Refs& refs, int n_refs,
                                          bool invert, int64_t left) {
  float4 v[kCountVecs];
#pragma unroll
  for (int j = 0; j < kCountVecs; ++j) v[j] = __ldg(p + j * kBlock);
  int n = 0;
#pragma unroll
  for (int j = 0; j < kCountVecs; ++j) {
    const float c[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    const int64_t cell = 4 * (static_cast<int64_t>(j) * kBlock + threadIdx.x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!TAIL || cell + e < left)
        n += sense_bit<KIND, NREFS>(c[e], refs, n_refs) != invert;
    }
  }
  return n;
}

// Grid-stride over the units, rows in table order: unit u is tile
// u % per_row of row u / per_row, whose address the block looks up in the
// tables (one slot, read by every thread at once). Neighbouring blocks read
// neighbouring tiles. Each block adds its sum to *out with one atomic.
template <int KIND, int NREFS = kMaxRefs>
__global__ void __launch_bounds__(kBlock)
sense_popcount_kernel(const RowTables tables, int n_tables,
                      int* __restrict__ out, int64_t cols, int64_t valid,
                      int units, Refs refs, int n_refs, int invert) {
  const int per_row = static_cast<int>(cols / kTileCols);
  const int full = static_cast<int>(valid / kTileCols);  // units wholly counted
  int count = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / per_row;
    int i = 0;
    while (i + 1 < n_tables && row >= tables.end[i]) ++i;
    const float4* p =
        reinterpret_cast<const float4*>(table_row(
            tables, i, row - (i ? tables.end[i - 1] : 0), cols)) +
        static_cast<int64_t>(u - row * per_row) * (kTileCols / 4) + threadIdx.x;
    count += u < full
                 ? count_unit<KIND, NREFS, false>(p, refs, n_refs, invert != 0, 0)
                 : count_unit<KIND, NREFS, true>(
                       p, refs, n_refs, invert != 0,
                       valid - static_cast<int64_t>(u) * kTileCols);
  }
  block_add(count, out);
}

// Launch one instance over `units` units on a grid of the blocks the card
// holds at once (its SMs times what one SM holds of this instance).
template <int KIND, int NREFS = kMaxRefs>
void launch_sense_popcount(const RowTables& tables, int n_tables, int* out,
                           int64_t cols, int64_t valid, int units,
                           const Refs& refs, int n_refs, int invert,
                           cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sense_popcount_kernel<KIND, NREFS>, kBlock, 0);
    per_sm = n > 0 ? n : 1;
  }
  const int64_t cap = resident_blocks() / (2048 / kBlock) * per_sm;
  const unsigned int grid = static_cast<unsigned int>(units < cap ? units : cap);
  sense_popcount_kernel<KIND, NREFS><<<grid, kBlock, 0, stream>>>(
      tables, n_tables, out, cols, valid, units, refs, n_refs, invert);
}

// Read plans one multi-plan sense launch takes.
constexpr int kMaxPlans = 8;
// Words one thread of mlc_sense_multi_kernel senses: one float4 of cells
// for each of a word's 32 bits.
constexpr int kMultiVec = 4;
constexpr int kMultiBlock = 128;

// P read plans by value: plan p senses under kind[p] with refs[p], and
// inverts its words where invert[p].
struct Plans {
  Refs refs[kMaxPlans];
  int kind[kMaxPlans];
  int invert[kMaxPlans];
};

// The kMultiVec words of one plan of kind KIND over the thread's cells.
template <int KIND>
__device__ __forceinline__ void sense_cells(const float4 (&v)[kWordBits],
                                            const Refs& refs,
                                            uint32_t (&word)[kMultiVec]) {
#pragma unroll
  for (int j = 0; j < kMultiVec; ++j) word[j] = 0;
#pragma unroll
  for (int k = 0; k < kWordBits; ++k) {
    word[0] |= static_cast<uint32_t>(sense_bit<KIND>(v[k].x, refs, 0)) << k;
    word[1] |= static_cast<uint32_t>(sense_bit<KIND>(v[k].y, refs, 0)) << k;
    word[2] |= static_cast<uint32_t>(sense_bit<KIND>(v[k].z, refs, 0)) << k;
    word[3] |= static_cast<uint32_t>(sense_bit<KIND>(v[k].w, refs, 0)) << k;
  }
}

// One thread per kMultiVec words of one output row; a block covers
// kMultiBlock * kMultiVec words of one row, whose address its first thread
// looks up in the tables. Plan p's words go to out + p * plane.
__global__ void __launch_bounds__(kMultiBlock)
mlc_sense_multi_kernel(const RowTables tables, int n_tables,
                       uint32_t* __restrict__ out, int64_t plane,
                       int64_t words, int64_t blocks_per_row,
                       const Plans plans, int n_plans) {
  __shared__ const float* src;
  __shared__ Plans sp;
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t w0 =
      ((blockIdx.x % blocks_per_row) * kMultiBlock + threadIdx.x) * kMultiVec;
  if (threadIdx.x == 0) {
    int i = 0;
    while (i + 1 < n_tables && row >= tables.end[i]) ++i;
    src = table_row(tables, i, row - (i ? tables.end[i - 1] : 0),
                    words * kWordBits);
    sp = plans;
  }
  __syncthreads();
  if (w0 >= words) return;
  const float4* base = reinterpret_cast<const float4*>(
      src + (w0 / kLanes) * kTileCols + w0 % kLanes);
  float4 v[kWordBits];
#pragma unroll
  for (int k = 0; k < kWordBits; ++k) v[k] = __ldg(base + k * (kLanes / 4));
  uint32_t* dst = out + row * words + w0;
#pragma unroll 1
  for (int p = 0; p < n_plans; ++p) {
    const Refs refs = sp.refs[p];
    uint32_t word[kMultiVec];
    if (sp.kind[p] == kLsb)
      sense_cells<kLsb>(v, refs, word);
    else if (sp.kind[p] == kMsb)
      sense_cells<kMsb>(v, refs, word);
    else
      sense_cells<kSbr>(v, refs, word);
    const uint32_t flip = sp.invert[p] ? ~0u : 0u;
    *reinterpret_cast<uint4*>(dst + p * plane) =
        make_uint4(word[0] ^ flip, word[1] ^ flip, word[2] ^ flip,
                   word[3] ^ flip);
  }
}

}  // namespace mcf

// `bases`, `slots` and `ends` are host arrays of `n_tables` (1..kMaxTables)
// entries: table i's rows are the output rows [ends[i-1], ends[i]), and
// ends[n_tables - 1] == rows.
extern "C" int mcf_mlc_sense(const float* const* bases,
                             const int32_t* const* slots, const int64_t* ends,
                             int n_tables, uint32_t* out, int64_t rows,
                             int64_t cols, int kind, int n_refs, int invert,
                             const float* host_refs, cudaStream_t stream) {
  using namespace mcf;
  if (n_tables < 1 || n_tables > kMaxTables || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mlc_sense(
      load_tables(bases, slots, ends, n_tables), n_tables, out,
      Span{0, nullptr, 0}, rows, cols,
      kind, load_refs(host_refs), n_refs, invert, stream));
}

// The rows as mcf_mlc_sense takes them, to the same words in `out`, sensed
// `chunk` rows at a time on `stream`, one launch a chunk; after each chunk
// an event lets `copy_stream` copy that chunk's words to the same offset of
// `host` (pinned). With `mask`, the words of rows from `mask_row` on are
// ANDed with the mask's words at the same offsets as they are written. The
// last chunk's copy is the last work this call enqueues on `copy_stream`.
// One event per device is re-recorded for each chunk: a stream's wait takes
// the event as it stands when the wait is enqueued, so later records do not
// move it.
extern "C" int mcf_mlc_sense_drain(const float* const* bases,
                                   const int32_t* const* slots,
                                   const int64_t* ends, int n_tables,
                                   uint32_t* out, uint32_t* host, int64_t rows,
                                   int64_t cols, int64_t chunk,
                                   const uint32_t* mask, int64_t mask_row,
                                   int kind, int n_refs, int invert,
                                   const float* host_refs,
                                   cudaStream_t copy_stream,
                                   cudaStream_t stream) {
  using namespace mcf;
  if (n_tables < 1 || n_tables > kMaxTables || rows < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kMaxDevices = 64;
  static cudaEvent_t made[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (made[dev] == nullptr) {
    err = cudaEventCreateWithFlags(&made[dev], cudaEventDisableTiming);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const RowTables tables = load_tables(bases, slots, ends, n_tables);
  const Refs refs = load_refs(host_refs);
  const int64_t words = cols / kWordBits;
  for (int64_t r0 = 0; r0 < rows; r0 += chunk) {
    const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
    const Span span{r0, mask != nullptr && r1 > mask_row ? mask : nullptr,
                    mask_row};
    err = launch_mlc_sense(tables, n_tables, out, span, r1 - r0, cols, kind,
                           refs, n_refs, invert, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t w0 = r0 * words;
    if ((err = cudaEventRecord(made[dev], stream)) != cudaSuccess ||
        (err = cudaStreamWaitEvent(copy_stream, made[dev], 0)) != cudaSuccess ||
        (err = cudaMemcpyAsync(host + w0, out + w0,
                               (r1 - r0) * words * sizeof(uint32_t),
                               cudaMemcpyDeviceToHost, copy_stream)) !=
            cudaSuccess)
      return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The rows as mcf_mlc_sense takes them; `*out` gets the count of the cells
// that sense to 1 among the first `valid` (row r's cell c is cell r * cols +
// c; at most rows * cols). With `zero` the entry zeroes *out on `stream`
// first, else it adds to it (a later launch of more than kMaxTables tables).
// Every base must be 16-byte aligned.
extern "C" int mcf_sense_popcount(const float* const* bases,
                                  const int32_t* const* slots,
                                  const int64_t* ends, int n_tables, int* out,
                                  int64_t rows, int64_t cols, int64_t valid,
                                  int kind, int n_refs, int invert, int zero,
                                  const float* host_refs, cudaStream_t stream) {
  using namespace mcf;
  if (n_tables < 1 || n_tables > kMaxTables || rows < 1 || cols < kTileCols ||
      cols % kTileCols || valid > rows * cols ||
      (rows * cols + kTileCols - 1) / kTileCols > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_tables; ++i)
    if (!aligned16(bases[i])) return static_cast<int>(cudaErrorInvalidValue);
  if (zero) {
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (valid <= 0) return static_cast<int>(cudaSuccess);
  const int units = static_cast<int>((valid + kTileCols - 1) / kTileCols);
  const RowTables tables = load_tables(bases, slots, ends, n_tables);
  const Refs refs = load_refs(host_refs);
  switch (kind) {
    case kLsb:
      launch_sense_popcount<kLsb>(tables, n_tables, out, cols, valid, units, refs, n_refs, invert, stream);
      break;
    case kMsb:
      launch_sense_popcount<kMsb>(tables, n_tables, out, cols, valid, units, refs, n_refs, invert, stream);
      break;
    case kSbr:
      launch_sense_popcount<kSbr>(tables, n_tables, out, cols, valid, units, refs, n_refs, invert, stream);
      break;
    case kParity:
      // one- and two-reference parity reads (TLC AND3 / OR3, reduced-MLC
      // AND) get their own instances, as in mcf_mlc_sense
      if (n_refs == 1)
        launch_sense_popcount<kParity, 1>(tables, n_tables, out, cols, valid, units, refs, n_refs, invert, stream);
      else if (n_refs == 2)
        launch_sense_popcount<kParity, 2>(tables, n_tables, out, cols, valid, units, refs, n_refs, invert, stream);
      else
        launch_sense_popcount<kParity>(tables, n_tables, out, cols, valid, units, refs, n_refs, invert, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rows as mcf_mlc_sense takes them, sensed under `n_plans`
// (1..kMaxPlans) read plans in one pass: plan p's words (mcf_mlc_sense's
// layout) go to out + p * plane, where plane >= rows * cols / 32 words.
// `kinds` and `inverts` are host arrays of n_plans entries and `host_refs`
// of n_plans * kMaxRefs; each kind is lsb, msb or sbr. Every
// base and `out` must be 16-byte aligned, and `plane` a multiple of 4.
extern "C" int mcf_mlc_sense_multi(const float* const* bases,
                                   const int32_t* const* slots,
                                   const int64_t* ends, int n_tables,
                                   uint32_t* out, int64_t plane, int64_t rows,
                                   int64_t cols, int n_plans, const int* kinds,
                                   const int* inverts, const float* host_refs,
                                   cudaStream_t stream) {
  using namespace mcf;
  const int64_t words = cols / kWordBits;
  if (n_tables < 1 || n_tables > kMaxTables || rows < 1 || cols < kTileCols ||
      cols % kTileCols || n_plans < 1 || n_plans > kMaxPlans ||
      plane < rows * words || plane % kMultiVec || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_tables; ++i)
    if (!aligned16(bases[i])) return static_cast<int>(cudaErrorInvalidValue);
  Plans plans = {};
  for (int p = 0; p < n_plans; ++p) {
    if (kinds[p] != kLsb && kinds[p] != kMsb && kinds[p] != kSbr)
      return static_cast<int>(cudaErrorInvalidValue);
    plans.kind[p] = kinds[p];
    plans.invert[p] = inverts[p];
    plans.refs[p] = load_refs(host_refs + p * kMaxRefs);
  }
  const int64_t blocks_per_row =
      (words + kMultiBlock * kMultiVec - 1) / (kMultiBlock * kMultiVec);
  mlc_sense_multi_kernel<<<static_cast<unsigned int>(rows * blocks_per_row),
                           kMultiBlock, 0, stream>>>(
      load_tables(bases, slots, ends, n_tables), n_tables, out, plane, words,
      blocks_per_row, plans, n_plans);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mcf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
