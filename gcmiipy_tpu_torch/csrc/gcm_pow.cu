// pow for double as PyTorch's own kernels round it, for the float64
// libraries (ops/cuda_lib.py).  The kernel sources build with -fmad=false,
// so that each a*b+c rounds twice as the plain versions' separate
// elementwise ops do; that flag also reaches the CUDA math library's double
// pow compiled into them, which then rounds apart from PyTorch's (built
// with nvcc's default contraction) in some values.  So the float64
// libraries take double pow from here: a translation unit of its own,
// built with the default contraction and linked as relocatable device
// code (gcm_stencil.cuh: power).  float's powf rounds alike under both
// flags and stays inline.

#include <math.h>

namespace gcm {

__device__ double pow_contracted(double x, double y) { return pow(x, y); }

}  // namespace gcm
