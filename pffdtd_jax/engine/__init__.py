from pffdtd_jax.engine.coeffs import SchemeCoeffs, MatCoeffs  # noqa: F401
from pffdtd_jax.engine.numpy_ref import NumpyEngine  # noqa: F401
