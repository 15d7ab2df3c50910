// The NUTS tree kernel's general entries for Hopper (sm_90a): the trees of
// csrc/nuts_tree.cu (which describes the algorithm and both layouts) to
// depth 30, with a forced trajectory length and the capture of lane
// (T0, C0)'s trajectory. nuts_general.cuh holds the kernels and says why
// they are kernels of their own; ops/nuts.py launches them where the
// default entries do not take the call.

#include "nuts_general.cuh"

// All arrays are device pointers, as nuts_tree_curved's and
// nuts_tree_<functor>'s; see PTMC_NUTS_GENERAL_ENTRY. Launches on `stream`,
// does not synchronise and allocates nothing. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a depth outside [1, 30], a D the functor does
// not take, or 2**31 chains or more.
PTMC_NUTS_GENERAL_ENTRY(curved, ptmc::CurvedLikelihood, launch_general)
PTMC_NUTS_GENERAL_WIDE_ENTRY(correlated_gaussian, ptmc::WideCorrelatedGaussian)
PTMC_NUTS_GENERAL_WIDE_ENTRY(interval_gaussian, ptmc::WideIntervalGaussian)
PTMC_NUTS_GENERAL_WIDE_ENTRY(hierarchical_gaussian, ptmc::WideHierarchicalGaussian)
