"""``tests/test_root_mismatch.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name:
rooted collectives whose ranks disagree on the root
fail on every rank, an invalid root raises, an agreeing non-zero root works."""

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_root_mismatch"))
