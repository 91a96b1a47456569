// The element-type codes the C entry points take for their tensors. The
// Python wrappers pass them from ray_tpu_torch._build.DTYPE_CODES.

#pragma once

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr int kDtypeF16 = 2;
