"""The analytic SHT cost model behind ``make_plan(mode="model")``
(``analysis``), the per-hardware characterization store of measured
corner timings behind ``mode="auto"`` (``chardb``), and the serving
engine's admission control on that model (``admission``)."""
from repro_torch.roofline import chardb  # noqa: F401
from repro_torch.roofline.admission import (  # noqa: F401
    default_model, k_caps_for_target,
)
from repro_torch.roofline.analysis import (  # noqa: F401
    BACKEND_MODELS, HW_H100, HW_HOST, BackendModel, Hardware,
    hardware_for, legendre_panel_counts, predict_sht_time, sht_work,
)
