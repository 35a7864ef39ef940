// The cluster group of the CPU emulation (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::ctx.blk->rank; }
  void sync() const { emu::cluster_sync(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return static_cast<T*>(emu::map_shared(p, rank));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
