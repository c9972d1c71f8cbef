"""The multi-device runtime: ring collectives over the flat mesh
(``collectives``) and the work-stealing chunk scheduler on CUDA streams
(``scheduler``)."""
