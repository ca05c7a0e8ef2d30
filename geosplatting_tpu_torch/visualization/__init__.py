"""Host-side visualization (counterpart of ``geosplatting_tpu/visualization``):
a standalone WebGL splat viewer page (``vis_3dgs``), the turntable camera
schedule of training-time frames (``OptimizationVisualizer``), an offline
animation compositor (``Director``) and figure grids (``TabularFigures``).
"""
from .director import Director, Fade, Grid, Leaf  # noqa: F401
from .figures import TabularFigures, highlight_crop  # noqa: F401
from .turntable import OptimizationVisualizer  # noqa: F401
from .viewer_html import vis_3dgs  # noqa: F401
