from pffdtd_jax.analysis.air_abs import (  # noqa: F401
    air_absorption,
    apply_modal_filter,
    apply_ola_filter,
    apply_visco_filter,
)
from pffdtd_jax.analysis.process_outputs import ProcessOutputs  # noqa: F401
