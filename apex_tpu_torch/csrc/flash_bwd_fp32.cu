// Flash-attention backward (dq and dk/dv) for fp32 q, k, v: the wgmma/TMA
// kernels of flash_bwd32_sm90.cuh, exact products from three bf16 parts a
// value, on the planes the split pass (flash_split3.cu) writes.

#include "flash_bwd32_sm90.cuh"

APEX_EXPORT_FLASH_BWD(float)
