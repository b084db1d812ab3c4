// Flash-attention forward for fp16 q, k, v: the kernels of
// flash_fwd.cuh (the fp16 `mma`, P and dS rounded to fp16).

#include "flash_fwd.cuh"

APEX_EXPORT_FLASH_FWD(__half)
