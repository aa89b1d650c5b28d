# The XGO robot actor and its teleop client (examples/xgo_robot/) on the
# port.
