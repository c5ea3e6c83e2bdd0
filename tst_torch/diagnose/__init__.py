"""Bias scores s(x) (counterpart of ``tst.diagnose``)."""
