"""Core math: kinematics, Fourier machinery, group encodings."""
from repro_torch.core import encodings, fourier, kinematics
from repro_torch.core.encodings import GroupEncoding, SE2Fourier, make_encoding

__all__ = ["encodings", "fourier", "kinematics", "GroupEncoding",
           "SE2Fourier", "make_encoding"]
