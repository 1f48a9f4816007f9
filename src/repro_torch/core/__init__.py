"""QMC compute core (port of ``repro.core``): AO -> MO -> Slater -> local
energy, the Propagator/Driver API and the VMC / single-electron-move
propagators."""
