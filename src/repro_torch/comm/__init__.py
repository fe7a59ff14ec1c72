"""Wire format and collective exchange of the port (twin of
``src/repro/comm``)."""
