"""The port's planning analysis: :mod:`opcount` counts one device's program
on the ``meta`` device, :mod:`roofline` turns the counts into the three
roofline terms over the card's spec and holds every kernel's cost."""
from repro_torch.analysis import opcount, roofline  # noqa: F401
