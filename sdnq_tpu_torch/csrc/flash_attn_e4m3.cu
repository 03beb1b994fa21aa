// B3 / B9 with e4m3 Q.K^T: flash_attn.cuh's kernels for that kind and its
// C entries (bf16 and int8 Q.K^T: flash_attn.cu), built apart so that the
// two compile in parallel.
#define SDNQ_FLASH_E4M3
#include "flash_attn.cuh"
