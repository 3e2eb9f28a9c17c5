// The threads of one native call, for neighbor.cpp and partition.cpp.
//
// OpenMP's thread count is a per-thread setting shared with every other
// user of the process's OpenMP runtime (PyTorch's intra-op pool loads the
// same libgomp): set it for the call only and put the caller's back.
#pragma once

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Below this many atoms a call's loops run on the calling thread (the
// parallel regions' `if` clauses): the work is tens of microseconds, and a
// team's barriers cost tens of milliseconds each once the host's cores are
// oversubscribed (several processes, each with a team per core). The
// output does not depend on the thread count.
constexpr int64_t kMinAtomsForThreads = 512;

struct ThreadCountScope {
  int saved = 0;
  bool set = false;
  explicit ThreadCountScope(int n) {
#ifdef _OPENMP
    if (n > 0) {
      saved = omp_get_max_threads();
      omp_set_num_threads(n);
      set = true;
    }
#endif
  }
  ~ThreadCountScope() {
#ifdef _OPENMP
    if (set) omp_set_num_threads(saved);
#endif
  }
};

}  // namespace
