"""Roofline of the port's cells: the analytic flop/byte model
(``analytic``), its terms on the card's published peaks (``analysis``) and
the report (``report``). The reference's ``hlo_parse.py`` (collective bytes
read from compiled HLO) has no counterpart yet: collective bytes come with
the dry run on a fake process group (ROADMAP Queue 1 item 14.2).
"""
