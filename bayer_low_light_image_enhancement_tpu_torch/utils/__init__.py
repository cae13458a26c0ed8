"""Utilities: the metrics logger (``logging``), profiling and timing
(``profiling``, ``time_trees``), parameter and operation counts
(``flops``) and numerical debugging (``debug``)."""
