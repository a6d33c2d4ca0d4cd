"""Model builders: the seven-net CNN zoo as GCONV chains."""
