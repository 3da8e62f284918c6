r"""Base class for reusable model blocks (cells, encoders, ...): an
``nn.Module`` carrying provenance constants."""
from torch import nn


class VPModelBlock(nn.Module):
    r"""Base module for all model blocks."""
    NAME = None
    PAPER_REFERENCE = None
    CODE_REFERENCE = None
    MATCHES_REFERENCE = None
