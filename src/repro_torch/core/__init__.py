"""QMC compute core (port of ``repro.core``): AO -> MO -> Slater -> local
energy, the Propagator/Driver API (walker-axis sharding included) and the
VMC / DMC / single-electron-move propagators."""
from repro_torch.core.driver import (BlockStats, EnsembleDriver, Population,
                                     Propagator, WALKER_AXIS,
                                     make_propagator, register_method,
                                     restart_ensemble)

__all__ = ['BlockStats', 'EnsembleDriver', 'Population', 'Propagator',
           'WALKER_AXIS', 'make_propagator', 'register_method',
           'restart_ensemble']
