"""``tests/test_serialization.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name:
the by-value codec (closures, local classes, enums, slots,
shared cells, the marshal tag) the port's object messages ride on."""

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_serialization"))
