"""The loops that drive one entry of the port each, found by the name a
traffic mix gives."""
