from meshopticalflow_tpu_torch.parallel.distributed import (
    DeviceGroup,
    global_device_group,
    maybe_init_distributed,
)
from meshopticalflow_tpu_torch.parallel.sharding import (
    Rows,
    place_problem,
    sharded_level_step,
    advect_texture_sharded,
)
from meshopticalflow_tpu_torch.parallel.halo import (
    HaloCoarse,
    HaloEll,
    build_halo_coarse,
    build_halo_ell,
    halo_mg_pcg,
    halo_pcg,
)
