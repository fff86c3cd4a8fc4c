"""The port's fault-tolerance pieces the serving supervisor uses
(``fault_tolerance``); sharded serving and training come later."""
