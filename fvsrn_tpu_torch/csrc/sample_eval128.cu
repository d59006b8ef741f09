// The sample evaluator's value instance at hidden width 128 (warp_mlp.cuh's
// wide plan; no gradient instance), a library of its own.
#define SAMPLE_EVAL_WIDE 1
#include "sample_eval.cu"
