"""Visual DSP: spectrum/waterfall/scope processing as batched array programs.

The reference renders through OpenGL canvases fed by processor threads
(SURVEY.md §2.6-2.7); here the processors emit display-ready arrays
(normalized spectrum points, waterfall RGB rows, scope traces) that any
frontend — a notebook, a web viewer, an image writer — can draw. All the
display *math* (double-EMA smoothing, auto floor/ceil, peak hold, log
scaling, palettes) is bit-faithful to the reference.
"""

from cubicsdr.visual.spectrum import SpectrumProcessor  # noqa: F401
from cubicsdr.visual.planar_spectrum import (  # noqa: F401
    PlanarSpectrumProcessor)
from cubicsdr.visual.distributor import FFTDataDistributor  # noqa: F401
from cubicsdr.visual.scope import ScopeProcessor  # noqa: F401
from cubicsdr.visual.waterfall import Waterfall  # noqa: F401
from cubicsdr.visual.gradient import Gradient, THEMES  # noqa: F401
