"""``tests/test_info.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name:
``Info`` objects: dict behaviour, validation, ``free``."""

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_info"))
