from .camera import generate_rays, LensArrays  # noqa: F401
from .sensor import Sensor, accumulate  # noqa: F401
from .renderer import render, render_sample, render_spp  # noqa: F401
