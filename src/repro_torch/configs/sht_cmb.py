"""The paper's own configuration: distributed SHT for CMB-scale problems.

Shapes (paper §5 and the target-application sizes):
  * synth_2k_k8   -- l_max=2048,  K=8   (Monte-Carlo batch, GL grid)
  * synth_4k_k1   -- l_max=4096,  K=1   (paper's headline single-map size)
  * anal_4k_k4    -- l_max=4096,  K=4, direct transform
  * synth_8k_k4   -- l_max=8192,  K=4   (Planck-scale)
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SHTConfig:
    name: str
    l_max: int
    K: int
    direction: str = "synth"     # synth | anal
    grid: str = "gl"
    fold: bool = False           # paper-faithful baseline: fold off
    comm_dtype: str | None = None
    dtype: str = "float32"


CONFIG = SHTConfig(name="sht_cmb", l_max=4096, K=1)

SHT_SHAPES = {
    "synth_2k_k8": SHTConfig("sht_cmb", 2048, 8, "synth"),
    "synth_4k_k1": SHTConfig("sht_cmb", 4096, 1, "synth"),
    "anal_4k_k4": SHTConfig("sht_cmb", 4096, 4, "anal"),
    "synth_8k_k4": SHTConfig("sht_cmb", 8192, 4, "synth"),
}
