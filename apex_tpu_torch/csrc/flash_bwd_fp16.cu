// Flash-attention backward (dq and dk/dv) for fp16 q, k, v: the kernels of
// flash_bwd.cuh (the fp16 `mma`, P and dS rounded to fp16).

#include "flash_bwd.cuh"

APEX_EXPORT_FLASH_BWD(__half)
