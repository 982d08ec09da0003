"""``tests/test_property.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name:
randomized lockstep rounds of collectives and
nonblocking interleavings, each result against numpy on the same seeded
inputs."""

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_property"))
