"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference, each number beside its limit."""
