// B3 / B9 with bf16 and int8 Q.K^T: flash_attn.cuh's kernels for those
// kinds and its C entries (e4m3 Q.K^T: flash_attn_e4m3.cu).
#include "flash_attn.cuh"
