// The sample evaluator at hidden width 128, a library of its own: the
// value instance on warp_mlp.cuh's wide plan, the gradient instance (one
// thread a position) on the packed weights in device memory.
#define SAMPLE_EVAL_WIDE 1
#include "sample_eval.cu"
