"""Roofline of the port's steps on one device: op-level costs of a traced
step (``op_costs``) and the three-term report (``report``)."""
