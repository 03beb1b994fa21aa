// B3 / B9 with e4m3 Q.K^T at every head dim: flash_attn.cuh's kernels for
// that kind and its C entries (bf16 and int8 Q.K^T: flash_attn.cu and
// flash_attn_d256.cu), built apart so that the libraries compile in
// parallel.
#define SDNQ_FLASH_E4M3
#include "flash_attn.cuh"
