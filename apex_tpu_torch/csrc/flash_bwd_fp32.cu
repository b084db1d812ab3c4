// Flash-attention backward (dq and dk/dv) for fp32 q, k, v: the kernels of
// flash_bwd.cuh, with exact products from three bf16 parts a value
// (flash_common.cuh).

#include "flash_bwd.cuh"

APEX_EXPORT_FLASH_BWD(float)
