"""Cell drivers, one a kind of configuration ("kind" in its file): each
sets the port up, drives the window and returns the run's record."""
