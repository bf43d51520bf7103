"""Analysis of simulated activity: peaks, Pearson correlation, EEG power
spectra and their earth mover's distance."""

from . import correlation, eeg, peaks
