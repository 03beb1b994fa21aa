// B3 / B9 with bf16 and int8 Q.K^T at head dims 64 and 128: flash_attn.cuh's
// kernels for those kinds and its C entries (head dim 256:
// flash_attn_d256.cu; e4m3 Q.K^T: flash_attn_e4m3.cu).
#include "flash_attn.cuh"
