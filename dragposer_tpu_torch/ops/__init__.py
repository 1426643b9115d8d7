"""Math: quaternions, dual quaternions, forward kinematics, topology,
and the temporal-transformer kernel (K2)."""
