// Flash-attention forward for fp32 q, k, v: the wgmma/TMA kernel of
// flash_fwd32_sm90.cuh, exact products from three bf16 parts a value, on
// the planes the split pass (flash_split3.cu) writes.

#include "flash_fwd32_sm90.cuh"

APEX_EXPORT_FLASH_FWD(float)
