from . import ga, fitting
from .ga import GeneticAlgorithmParameters, genetic_algo, decode_population
from .fitting import (FittingSettings, fit_neuron_to_neuron,
                      get_reference_summary, compare_summary, scale_summary,
                      SummaryScalingDefaults, run_coupled_trial)
