"""Roofline of the port's cells: the analytic flop/byte model
(``analytic``), its terms on the card's published peaks (``analysis``),
the collective bytes of a traced DTensor program (``collectives``, the
counterpart of the reference's ``hlo_parse.py``: the dry run's graphs on
a fake process group) and the report (``report``).
"""
