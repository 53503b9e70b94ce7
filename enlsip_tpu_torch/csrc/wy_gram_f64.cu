// The float64 half of the fused WY / Gram kernel: the source is
// wy_gram.cu, compiled here with its float64 entry point instead of its
// float32 one, so that the two sets of instantiations build side by side.
#define WY_GRAM_F64
#include "wy_gram.cu"
