"""Reports of the port's runs: ``report.py`` renders a serving trace."""
