"""Loops: how a mix's clients pace their calls, one module each, found by
the ``loop`` a mix names (``portbench/loop.py`` says what a module gives)."""
