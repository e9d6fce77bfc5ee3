// K-G route_rows: send every (tree, row) to its child after a level's splits.
//
// Replaces: transmogrifai_tpu/ops/trees.py::_grow_level row routing
// (:524-544) and the light-child membership of the next level (:418-422):
// a row in a slot that split goes right iff Xb[row, feat] > bin; its new
// slot is the child's slot, its pool node the child's pool index; a row
// whose slot did not split rests (slot -1, node unchanged).  The row's pair
// id for the next level's light-only histogram is its new slot / 2 when the
// new slot is the light child of its sibling pair, else -1, so the
// histogram kernel needs no extra pass.
//
// One thread per (tree, row); the new slots, nodes and pair ids go to new
// arrays, so a call never changes its inputs.  Bound on the card: bytes (a
// row's slot and node in and out, its pair id out, one bin and one 16-byte
// split record read).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename BinT>
__global__ void route_rows_kernel(const BinT* __restrict__ Xb,
                                  const int32_t* __restrict__ row_slot,
                                  const int32_t* __restrict__ row_node,
                                  const int4* __restrict__ split,
                                  const int32_t* __restrict__ pair_light,
                                  int32_t* __restrict__ new_slot, int32_t* __restrict__ new_node,
                                  int32_t* __restrict__ ids, int n, int d, int m, int pairs,
                                  int next_free) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (r >= n) return;
  const long long i = (long long)t * n + r;
  const int s = row_slot[i];
  int ns = -1, node = row_node[i];
  if (s >= 0) {
    const int4 sp = split[(long long)t * m + s];  // (feat or -1, bin, child slot, 0)
    if (sp.x >= 0) {
      const int right = (int)Xb[r * d + sp.x] > sp.y ? 1 : 0;
      ns = sp.z + right;
      node = next_free + ns;
    }
  }
  new_slot[i] = ns;
  new_node[i] = node;
  int id = -1;
  if (ns >= 0 && (ns >> 1) < pairs) {
    const bool light_left = pair_light[(long long)t * pairs + (ns >> 1)] != 0;
    const bool left = (ns & 1) == 0;
    if (left == light_left) id = ns >> 1;
  }
  ids[i] = id;
}

template <typename BinT>
int launch(const void* Xb, const void* row_slot, const void* row_node, const void* split,
           const void* pair_light, void* new_slot, void* new_node, void* ids, int n, int d,
           int T, int m, int pairs, int next_free, void* stream) {
  if (n <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, T);
  route_rows_kernel<BinT><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const BinT*)Xb, (const int32_t*)row_slot, (const int32_t*)row_node, (const int4*)split,
      (const int32_t*)pair_light, (int32_t*)new_slot, (int32_t*)new_node, (int32_t*)ids, n,
      d, m, pairs, next_free);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int route_rows_i8(const void* Xb, const void* row_slot, const void* row_node,
                             const void* split, const void* pair_light, void* new_slot,
                             void* new_node, void* ids, int n, int d, int T, int m, int pairs,
                             int next_free, void* stream) {
  return launch<int8_t>(Xb, row_slot, row_node, split, pair_light, new_slot, new_node, ids, n,
                        d, T, m, pairs, next_free, stream);
}

extern "C" int route_rows_i32(const void* Xb, const void* row_slot, const void* row_node,
                              const void* split, const void* pair_light, void* new_slot,
                              void* new_node, void* ids, int n, int d, int T, int m, int pairs,
                              int next_free, void* stream) {
  return launch<int32_t>(Xb, row_slot, row_node, split, pair_light, new_slot, new_node, ids,
                         n, d, T, m, pairs, next_free, stream);
}
