"""The parameter server of the serving tier."""
