"""``tests/test_datatype.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name:
derived datatypes (padded and nested structs, odd
primitives, ``MPI.Types`` constructors, struct round trips over
point-to-point)."""

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_datatype"))
