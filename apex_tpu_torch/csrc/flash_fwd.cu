// Flash-attention forward for bf16 q, k, v: the kernels of
// flash_fwd.cuh, which says what they replace, what bounds them and how
// they are built. One library a dtype (flash_fwd.cu bf16,
// flash_fwd_fp16.cu, flash_fwd_fp32.cu), so that the three build in
// parallel.

#include "flash_fwd.cuh"

APEX_EXPORT_FLASH_FWD(__nv_bfloat16)
