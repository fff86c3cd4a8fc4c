"""The port's fault-tolerance pieces (``fault_tolerance``): the serving
supervisor's heartbeats and the elastic restart plan; sharded serving
and training come later."""
