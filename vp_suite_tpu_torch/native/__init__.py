r"""The port's native host library: MMF's C generator and the PNG row
un-filtering, built with the system C compiler at first use."""
from vp_suite_tpu_torch.native.build import (generate_sequence_native, load_native,
                                             png_unfilter_native)

__all__ = ["generate_sequence_native", "load_native", "png_unfilter_native"]
