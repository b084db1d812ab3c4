// Flash-attention forward for fp16 q, k, v: the wgmma/TMA kernel of
// flash_fwd_sm90.cuh (the fp16 `wgmma`, P rounded to fp16).

#include "flash_fwd_sm90.cuh"

APEX_EXPORT_FLASH_FWD(__half)
