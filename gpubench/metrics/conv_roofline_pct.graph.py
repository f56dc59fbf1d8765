"""Least time of the plan's 3x3 convs over the conv kernels' traced time."""
from gpubench.readers import conv_roofline_pct as read  # noqa: F401
