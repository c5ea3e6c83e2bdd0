"""Bias scores s(x) and the RF diagnostic (counterpart of ``tst.diagnose``)."""
