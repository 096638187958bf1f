// HK01 fixture: a kernel source outside veneur_tpu_torch/csrc/ (and not
// in variants/): flagged at its first line.
__global__ void stray(float *x) { x[threadIdx.x] += 1.0f; }
