"""Drivers: ``<family>_<mode>.py`` builds the program under test for one
family of configurations, runs one mode of traffic through it, and
judges its outputs against the plain reference.  Each has
``run(session.Run)``."""
