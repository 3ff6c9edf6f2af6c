"""Tolerance ladder of the verification suite, the port's copy of
``mini_opt_tpu/utils/tol.py`` (the C++ reference's test/test_utils.hpp:10-17
constants)."""

DECI = 1.0e-1
CENTI = 1.0e-2
MILLI = 1.0e-3
MICRO = 1.0e-6
NANO = 1.0e-9
PICO = 1.0e-12
