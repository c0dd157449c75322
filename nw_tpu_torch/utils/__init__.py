"""Host-side utilities: text I/O, ANSI formatting, table rendering
(copies of ``nw_tpu/utils``, with the native runtime of this package)."""
