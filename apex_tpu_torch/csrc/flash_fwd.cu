// Flash-attention forward for bf16 q, k, v: the wgmma/TMA kernel of
// flash_fwd_sm90.cuh, which says what it replaces, what bounds it and how
// it is built. One library a dtype (flash_fwd.cu bf16, flash_fwd_fp16.cu,
// flash_fwd_fp32.cu), so that the three build in parallel.

#include "flash_fwd_sm90.cuh"

APEX_EXPORT_FLASH_FWD(__nv_bfloat16)
