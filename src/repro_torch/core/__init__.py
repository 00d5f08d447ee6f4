"""Core math: SE(2) group operations, kinematics, Fourier machinery, group
encodings and the paper's two attention algorithms."""
from repro_torch.core import encodings, fourier, kinematics, se2
from repro_torch.core import attention
from repro_torch.core.encodings import (ENCODINGS, AbsoluteEncoding,
                                        GroupEncoding, Rope1D, Rope2D,
                                        SE2Fourier, SE2Repr, make_encoding)

__all__ = ["attention", "encodings", "fourier", "kinematics", "se2",
           "ENCODINGS", "AbsoluteEncoding", "GroupEncoding", "Rope1D",
           "Rope2D", "SE2Fourier", "SE2Repr", "make_encoding"]
