// K18 row_scatter: an epoch's changed pack rows written in place into
// the resident device buffers, buf[idx[i]] = rows[i] for every changed
// field, in one launch.
//
// Replaces the reference's dirty-range scatter, kube_arbitrator_tpu/
// cache/arena.py:_scatter_donated (:156-159) as _DeviceResident.update
// (:182-250) calls it once per changed field: buf.at[idx].set(rows) with
// the previous buffer donated.  Here the host packs every changed
// field's row indices and rows, plus a descriptor table, into one staging
// buffer that reaches the card in one host-to-device copy; grid.y walks
// the descriptors (one per field) and grid.x strides over the field's
// (row, word) elements.  A descriptor is (dst pointer, rows offset, index
// offset, row count, row bytes); offsets are into the staging buffer and
// 16-byte aligned.  Rows whose width is a multiple of 4 bytes move as
// 32-bit words, others (bool rows of odd width) byte by byte.  Rank 1
// and rank 2 fields of bool, i32 and f32 are all rows of some bytes.
// Duplicate indices must carry identical rows (the reference's padded
// scatter relies on the same): the writes race but land the same bytes.
//
// Bound: bytes — the changed rows and indices read once from the staging
// buffer and the rows written once: ~0.2 MB for a 4%-churn epoch of the
// 50k x 5k pack (~0.1 us at 3.35 TB/s), so the launch and the copy's
// latency are the floor.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Desc {
  unsigned long long dst;      // device pointer of the resident buffer
  unsigned long long rows_off; // byte offset of the rows in the staging buffer
  unsigned long long idx_off;  // byte offset of the i32 row indices
  int nrows;
  int row_bytes;
};
static_assert(sizeof(Desc) == 32, "row_scatter.py packs 32-byte descriptors");

__global__ void __launch_bounds__(THREADS) row_scatter_kernel(const uint8_t* __restrict__ staging) {
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

extern "C" int kat_row_scatter(const uint8_t* staging, int nfields, int grid_x, void* stream) {
  if (nfields > 0 && grid_x > 0) {
    row_scatter_kernel<<<dim3(grid_x, nfields), THREADS, 0, (cudaStream_t)stream>>>(staging);
  }
  return (int)cudaGetLastError();
}
