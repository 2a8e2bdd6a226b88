// K18 row_scatter: an epoch's changed pack rows written in place into
// the resident device buffers, buf[idx[i]] = host[idx[i]] for every
// changed field, in one host-to-device copy and one launch.
//
// Replaces the reference's dirty-range scatter, kube_arbitrator_tpu/
// cache/arena.py:_scatter_donated (:156-159) as _DeviceResident.update
// (:182-250) calls it once per changed field: buf.at[idx].set(rows) with
// the previous buffer donated.  Here kat_row_scatter, called once an
// epoch by row_scatter.py's RowScatterPlan (which DeviceResident owns),
// takes the plan's requests, one a placed field (its resident buffer; and
// this epoch's host array and row indices where n > 0), and, on the host:
// waits until the plan's last kernel has started (it writes its epoch
// into a pinned flag word when it starts, so the last copy out of the
// pinned staging buffer is done: no event is recorded or waited on
// through the runtime; the wait is for callers that do not synchronise
// between epochs, DeviceResident.update does and never waits here),
// checks every index and gathers each changed
// field's rows and i32 indices straight from the host arrays into the
// pinned buffer behind a descriptor table; then it copies the used bytes
// to the plan's device staging buffer and launches.  The plan grows both
// staging buffers (doubling) when a call reports that they are too small,
// and reuses them.  On the card grid.y walks the descriptors (one per field)
// and grid.x strides over the field's (row, word) elements.  A
// descriptor is (dst pointer, rows offset, index offset, row count, row
// bytes); offsets are into the staging buffer and 16-byte aligned.  Rows
// whose width is a multiple of 4 bytes move as 32-bit words, others (bool
// rows of odd width) byte by byte.  Rank 1 and rank 2 fields of bool,
// i32 and f32 are all rows of some bytes.  Duplicate indices carry
// identical rows (each gathered from the one host row): the writes race
// but land the same bytes.
//
// Bound: bytes — the changed rows and indices cross the host link once
// (~45 GB/s measured for a 64 MB pinned copy), are read once from the
// staging buffer and the rows written once: ~34 KB for a 4%-churn epoch
// of the 50k x 5k pack (~0.7 us over the link, ~0.02 us at 3.35 TB/s), so
// the copy's and the launch's latency, and the host's work, are the floor.
#include <string.h>
#include <time.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr size_t MAX_GRID_X = 4096;  // blocks a field; each strides over the rest

// one field's descriptor in the staging buffer
struct Desc {
  unsigned long long dst;      // device pointer of the resident buffer
  unsigned long long rows_off; // byte offset of the rows in the staging buffer
  unsigned long long idx_off;  // byte offset of the i32 row indices
  int nrows;
  int row_bytes;
};
static_assert(sizeof(Desc) == 32, "32-byte descriptors");

// one field of the plan, changed this epoch when n > 0 (row_scatter.py's
// _Req mirrors this layout; kat_row_scatter sets n back to 0)
struct Req {
  const uint8_t* host;         // the field's host array, C-contiguous
  const void* rows;            // its changed row indices, i32 or i64
  unsigned long long dst;      // the resident buffer's device pointer
  int n;                       // changed rows
  int row_bytes;
  int rows_total;              // the field's rows: indices lie in [0, rows_total)
  int rows_wide;               // 1: rows is i64, 0: i32
};

constexpr int KAT_INDEX_ERROR = -1;  // an index outside its field (row_scatter.py raises)
constexpr int KAT_NEED_BYTES = -2;   // the staging is too small: *need says how big it must be
constexpr double WAIT_SECONDS = 10;  // the longest wait for the last launch before an error

size_t aligned(size_t n) { return (n + 15) & ~(size_t)15; }

double seconds() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

__global__ void __launch_bounds__(THREADS) row_scatter_kernel(const uint8_t* __restrict__ staging,
                                                               int* done, int epoch) {
  // the copy into the staging buffer is complete once this kernel runs:
  // tell the host its pinned buffer is free again
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *(volatile int*)done = epoch;
  const Desc d = reinterpret_cast<const Desc*>(staging)[blockIdx.y];
  const int* idx = reinterpret_cast<const int*>(staging + d.idx_off);
  const size_t stride = (size_t)gridDim.x * THREADS;
  if ((d.row_bytes & 3) == 0) {
    const int words = d.row_bytes >> 2;
    const size_t total = (size_t)d.nrows * words;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(staging + d.rows_off);
    uint32_t* dst = reinterpret_cast<uint32_t*>(d.dst);
    for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < total; e += stride) {
      const size_t r = e / words, w = e - r * words;
      dst[(size_t)idx[r] * words + w] = src[e];
    }
  } else {
    const size_t total = (size_t)d.nrows * d.row_bytes;
    const uint8_t* src = staging + d.rows_off;
    uint8_t* dst = reinterpret_cast<uint8_t*>(d.dst);
    for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < total; e += stride) {
      const size_t r = e / d.row_bytes, b = e - r * d.row_bytes;
      dst[(size_t)idx[r] * d.row_bytes + b] = src[e];
    }
  }
}

}  // namespace

// the device pointer of the plan's pinned flag word, fetched once a plan
extern "C" int kat_row_scatter_flag(int* done, int** done_dev) {
  return (int)cudaHostGetDevicePointer((void**)done_dev, done, 0);
}

// *last is the epoch of the plan's last launched kernel; a launch that is
// enqueued advances it, whatever follows
extern "C" int kat_row_scatter(void* reqs, int nreqs, uint8_t* pinned, uint8_t* staging, int cap,
                               int* done, int* done_dev, int* last, int* need, void* stream) {
  Req* rq = static_cast<Req*>(reqs);
  cudaStream_t s = (cudaStream_t)stream;
  // wait until the last launch has started: its copy out of the pinned
  // buffer is then done
  const volatile int* flag = done;
  const double t0 = seconds();
  for (unsigned spin = 0; *flag != *last; ++spin) {
    if ((spin & 1023) == 1023 && seconds() - t0 > WAIT_SECONDS) return (int)cudaErrorLaunchTimeout;
  }
  int nfields = 0;
  for (int f = 0; f < nreqs; ++f) nfields += rq[f].n > 0 && rq[f].row_bytes > 0;
  if (nfields == 0) return 0;
  size_t off = aligned(sizeof(Desc) * (size_t)nfields);
  for (int f = 0; f < nreqs; ++f) {
    if (rq[f].n > 0 && rq[f].row_bytes > 0)
      off = aligned(aligned(off + (size_t)rq[f].n * rq[f].row_bytes) + 4 * (size_t)rq[f].n);
  }
  if (off > (size_t)cap) {
    *need = off > 0x7fffffff ? 0x7fffffff : (int)off;
    return KAT_NEED_BYTES;  // the requests stay: the plan grows and calls again
  }
  Desc* desc = reinterpret_cast<Desc*>(pinned);
  int rc = 0;
  size_t words = 1;
  off = aligned(sizeof(Desc) * (size_t)nfields);
  for (int f = 0, d = 0; f < nreqs; ++f) {
    Req& q = rq[f];
    if (q.n <= 0 || q.row_bytes <= 0 || rc != 0) {
      q.n = 0;
      continue;
    }
    const size_t ro = off, io = aligned(ro + (size_t)q.n * q.row_bytes);
    off = aligned(io + 4 * (size_t)q.n);
    desc[d++] = Desc{q.dst, ro, io, q.n, q.row_bytes};
    int* idx = reinterpret_cast<int*>(pinned + io);
    uint8_t* out = pinned + ro;
    const size_t rb = q.row_bytes;
    for (int i = 0; i < q.n && rc == 0; ++i) {
      const long long r = q.rows_wide ? static_cast<const long long*>(q.rows)[i]
                                      : static_cast<const int*>(q.rows)[i];
      if (r < 0 || r >= q.rows_total) {
        rc = KAT_INDEX_ERROR;
        break;
      }
      idx[i] = (int)r;
      const uint8_t* src = q.host + (size_t)r * rb;
      if (rb == 4) memcpy(out + i * 4, src, 4);
      else if (rb == 1) out[i] = *src;
      else memcpy(out + i * rb, src, rb);
    }
    const size_t w = rb % 4 == 0 ? (size_t)q.n * rb / 4 : (size_t)q.n * rb;
    words = w > words ? w : words;
    q.n = 0;
  }
  if (rc != 0) return rc;
  cudaError_t e = cudaMemcpyAsync(staging, pinned, off, cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const size_t blocks = (words + THREADS - 1) / THREADS;
  const int grid_x = (int)(blocks < MAX_GRID_X ? blocks : MAX_GRID_X);
  int epoch = *last + 1;
  void* args[] = {&staging, &done_dev, &epoch};
  e = cudaLaunchKernel((const void*)row_scatter_kernel, dim3(grid_x, nfields), dim3(THREADS), args,
                       0, s);
  if (e == cudaSuccess) *last = epoch;  // the kernel is enqueued: it will stamp its epoch
  return (int)e;
}
