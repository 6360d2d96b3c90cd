from meshopticalflow_tpu_torch.viz.surface import (Camera, render_surface,
                                                   view_flow, view_spectrum)
from meshopticalflow_tpu_torch.viz.live import (KeyboardCallBack, LiveViewer,
                                                TerminalDisplay, render_rgb)
