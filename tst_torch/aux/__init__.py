"""Run logging of the port (its copy of tst.aux.log)."""
