"""Storage and quantization formats: sub-byte integer-image QNN algebra
(eqs. 1-4), chunk-planar packing, and the quantized-linear deployment
artifact. The names are the reference's ``repro.core`` re-exports; as
there, the function `quantize` shadows the module of that name, which
``importlib.import_module("repro_torch.core.quantize")`` reaches."""

from repro_torch.core.packing import (CHUNK, pack, unpack, unpack_planes,
                                      pack_factor, int_range, pad_to_chunk,
                                      padded_size, planar_perm)
from repro_torch.core.quantize import (QuantSpec, QuantizedLinearParams,
                                       quantize, dequantize, fake_quantize,
                                       lin, batchnorm_int, qnt_act,
                                       requantize_shift, requantize_shift_i64,
                                       fold_bn_requant, pick_requant_md,
                                       quantize_linear, M_BITS, D_MIN, D_MAX)
from repro_torch.core.calibration import (calibrate_weight,
                                          calibrate_activation,
                                          RunningCalibrator)
