// B3 / B9 with bf16 and int8 Q.K^T at head dim 256: flash_attn.cuh's
// kernels for those kinds at D 256 and its C entries, built apart so that
// the three libraries compile in parallel.
#define SDNQ_FLASH_D256
#include "flash_attn.cuh"
