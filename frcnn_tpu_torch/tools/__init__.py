"""Tools around the port that no path of it runs."""
