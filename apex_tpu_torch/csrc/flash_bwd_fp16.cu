// Flash-attention backward (dq and dk/dv) for fp16 q, k, v: the wgmma/TMA
// kernels of flash_bwd_sm90.cuh (the fp16 `wgmma`, P and dS rounded to
// fp16).

#include "flash_bwd_sm90.cuh"

APEX_EXPORT_FLASH_BWD(__half)
