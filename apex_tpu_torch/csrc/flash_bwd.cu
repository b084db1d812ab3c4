// Flash-attention backward (dq and dk/dv) for bf16 q, k, v: the wgmma/TMA
// kernels of flash_bwd_sm90.cuh, which says what they replace, what bounds
// them and how they are built. One library a dtype (flash_bwd.cu bf16,
// flash_bwd_fp16.cu, flash_bwd_fp32.cu), so that the three build in
// parallel.

#include "flash_bwd_sm90.cuh"

APEX_EXPORT_FLASH_BWD(__nv_bfloat16)
