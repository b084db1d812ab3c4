// Flash-attention forward for fp32 q, k, v: the kernels of
// flash_fwd.cuh, with exact products from three bf16 parts a value
// (flash_common.cuh).

#include "flash_fwd.cuh"

APEX_EXPORT_FLASH_FWD(float)
