"""CLI program endpoints of the port (the xmipp_<name> surface).

`main()` is the dispatcher: `python -m xmipp3_tpu_torch.programs <program>
[args...]`, or through a symlink/alias named `xmipp_<program>`. Programs
run on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import os
import sys

_P = "xmipp3_tpu_torch.programs."

# program name -> "module" (its PROGRAM attribute) or "module:Class"
_REGISTRY: dict[str, str] = {
    "angular_project_library": _P + "angular_project_library",
    "angular_projection_matching": _P + "angular_projection_matching",
    "reconstruct_fourier": _P + "reconstruct_fourier",
    "resolution_fsc": _P + "resolution_fsc",
    "ctf_phase_flip": _P + "ctf_correct:ProgCTFPhaseFlip",
    "ctf_correct_wiener2d": _P + "ctf_correct:ProgCTFCorrectWiener2D",
    "transform_filter": _P + "transform_filter",
    "transform_normalize": _P + "transform_normalize",
    "transform_geometry": _P + "transform_geometry",
    "image_align": _P + "image_align",
    "ctf_estimate_from_micrograph":
        _P + "ctf_estimate:ProgCTFEstimateFromMicrograph",
    "ctf_estimate_from_psd": _P + "ctf_estimate:ProgCTFEstimateFromPSD",
    "ctf_estimate_from_psd_fast":
        _P + "ctf_estimate:ProgCTFEstimateFromPSDFast",
    "ctf_group": _P + "ctf_correct:ProgCTFGroup",
    "ctf_sort_psds": _P + "ctf_correct:ProgCTFSortPSDs",
    "ctf_enhance_psd": _P + "ctf_correct:ProgCTFEnhancePSD",
    "ctf_estimate_psd_with_arma":
        _P + "resolution_dir:ProgCTFEstimatePSDWithARMA",
    "psd_estimate": _P + "resolution_dir:ProgPSDEstimate",
    "resolution_directional": _P + "resolution_dir:ProgResolutionDirectional",
    "movie_alignment_correlation":
        _P + "movie_alignment:ProgMovieAlignmentCorrelation",
    "movie_filter_dose": _P + "movie_alignment:ProgMovieFilterDose",
    "movie_estimate_gain": _P + "movie_alignment:ProgMovieEstimateGain",
    "phantom_movie": _P + "final_batch:ProgPhantomMovie",
    "resolution_monogenic_signal": _P + "resolution_misc:ProgMonoRes",
    "resolution_monotomo": _P + "resolution_misc:ProgMonoTomo",
    "resolution_fso": _P + "resolution_misc:ProgFSO",
    "resolution_localfilter":
        _P + "resolution_misc:ProgResolutionLocalFilter",
    "volume_correct_bfactor": _P + "resolution_misc:ProgVolumeCorrectBfactor",
    "volume_structure_factor":
        _P + "resolution_misc:ProgVolumeStructureFactor",
    "classify_CL2D": _P + "classify:ProgClassifyCL2D",
    "ml_align2d": _P + "classify:ProgMLAlign2D",
    "mlf_align2d": _P + "classify:ProgMLFAlign2D",
    "classify_kerdensom": _P + "classify:ProgKerdensom",
    "classify_CL2D_core_analysis":
        _P + "resolution_dir:ProgClassifyCL2DCoreAnalysis",
    "angular_accuracy_pca": _P + "resolution_dir:ProgAngularAccuracyPCA",
    "image_operate": _P + "image_operate",
    "transform_window": _P + "transform_misc:ProgTransformWindow",
    "transform_add_noise": _P + "transform_misc:ProgTransformAddNoise",
    "transform_threshold": _P + "transform_misc:ProgTransformThreshold",
    "transform_mirror": _P + "transform_misc:ProgTransformMirror",
    "transform_randomize_phases":
        _P + "transform_misc:ProgTransformRandomizePhases",
    "transform_downsample": _P + "transform_misc:ProgTransformDownsample",
    "image_resize": _P + "image_misc:ProgImageResize",
    "image_convert": _P + "image_misc:ProgImageConvert",
    "image_header": _P + "image_misc:ProgImageHeader",
    "image_statistics": _P + "image_misc:ProgImageStatistics",
    "image_histogram": _P + "image_misc:ProgImageHistogram",
    "metadata_utilities": _P + "metadata_utilities",
    "metadata_split": _P + "metadata_misc:ProgMetadataSplit",
    "metadata_import": _P + "metadata_misc:ProgMetadataImport",
    "metadata_histogram": _P + "metadata_misc:ProgMetadataHistogram",
    "angular_distance": _P + "metadata_misc:ProgAngularDistance",
    "angular_rotate": _P + "metadata_misc:ProgAngularRotate",
    "metadata_convert_emx": _P + "metadata_misc:ProgMetadataConvertEMX",
    "reconstruct_art": _P + "reconstruct_misc:ProgReconstructART",
    "reconstruct_wbp": _P + "reconstruct_misc:ProgReconstructWBP",
    "reconstruct_significant":
        _P + "reconstruct_misc:ProgReconstructSignificant",
    "align_significant": _P + "align_significant",
    "phantom_create": _P + "phantom_programs:ProgPhantomCreate",
    "phantom_project": _P + "phantom_programs:ProgPhantomProject",
    "project": _P + "phantom_programs:ProgPhantomProject",
    "phantom_simulate_microscope":
        _P + "phantom_programs:ProgPhantomSimulateMicroscope",
    "angular_continuous_assign2":
        _P + "angular_programs:ProgAngularContinuousAssign2",
    "angular_continuous_assign":
        _P + "angular_programs:ProgAngularContinuousAssign",
    "angular_class_average": _P + "angular_programs:ProgAngularClassAverage",
    "angular_neighbourhood": _P + "angular_programs:ProgAngularNeighbourhood",
    "subtract_projection": _P + "angular_programs:ProgSubtractProjection",
    "image_residuals": _P + "angular_programs:ProgImageResiduals",
    "angular_discrete_assign": _P + "angular_misc:ProgAngularDiscreteAssign",
    "angular_assignment_mag": _P + "angular_misc:ProgAngularAssignmentMag",
    "angular_break_symmetry": _P + "angular_misc:ProgAngularBreakSymmetry",
    "angular_estimate_tilt_axis":
        _P + "angular_misc:ProgAngularEstimateTiltAxis",
    "multireference_aligneability":
        _P + "angular_misc:ProgMultireferenceAligneability",
    "validation_nontilt": _P + "angular_misc:ProgValidationNonTilt",
    "compare_views": _P + "angular_misc:ProgCompareViews",
    "resolution_ssnr": _P + "ssnr_residuals:ProgResolutionSSNR",
    "continuous_create_residuals":
        _P + "ssnr_residuals:ProgContinuousCreateResiduals",
    "angular_commonline":
        _P + "angular_commonline_prog:ProgAngularCommonline",
    "image_vectorize": _P + "image_analysis:ProgImageVectorize",
    "image_sort": _P + "image_analysis:ProgImageSortChain",
    "image_sort_by_statistics":
        _P + "image_analysis:ProgImageSortByStatistics",
    "image_find_center": _P + "image_analysis:ProgImageFindCenter",
    "image_ssnr": _P + "image_analysis:ProgImageSSNR",
    "image_eliminate_empty_particles":
        _P + "image_analysis:ProgEliminateEmptyParticles",
    "matrix_dimred": _P + "image_analysis:ProgMatrixDimred",
    "image_rotational_pca": _P + "image_analysis:ProgImageRotationalPCA",
    "image_eliminate_byEnergy": _P + "image_analysis:ProgEliminateByEnergy",
    "classify_evaluate_classes":
        _P + "classify_analysis:ProgClassifyEvaluateClasses",
    "classify_analyze_cluster":
        _P + "classify_analysis:ProgClassifyAnalyzeCluster",
    "classify_extract_features":
        _P + "classify_analysis:ProgClassifyExtractFeatures",
    "classify_compare_classes":
        _P + "classify_analysis:ProgClassifyCompareClasses",
    "classify_first_split": _P + "classify_analysis:ProgClassifyFirstSplit",
    "classify_first_split3":
        _P + "classify_analysis:ProgClassifyFirstSplit3",
    "volume_halves_restoration":
        _P + "classify_analysis:ProgVolumeHalvesRestoration",
    "volume_find_symmetry": _P + "classify_analysis:ProgVolumeFindSymmetry",
    "run": _P + "classify_analysis:ProgMpiRun",
    "denoising_tv": _P + "classify_analysis:ProgDenoisingTV",
    "micrograph_scissor": _P + "micrograph_programs:ProgMicrographScissor",
    "micrograph_automatic_picking":
        _P + "micrograph_programs:ProgMicrographAutomaticPicking",
    "transform_dimred": _P + "misc_programs:ProgTransformDimred",
    "angular_distribution_show":
        _P + "misc_programs:ProgAngularDistributionShow",
    "image_odd_even": _P + "misc_programs:ProgImageOddEven",
    "transform_adjust_image_grey_levels":
        _P + "misc_programs:ProgAdjustGreyLevels",
    "local_volume_adjust": _P + "misc_programs:ProgLocalVolumeAdjust",
    "volume_local_sharpening":
        _P + "misc_programs:ProgVolumeLocalSharpening",
    "transform_morphology": _P + "misc_programs:ProgTransformMorphology",
    "transform_center_image": _P + "misc_programs:ProgTransformCenterImage",
    "volume_from_pdb": _P + "volume_programs:ProgVolumeFromPDB",
    "volume_center": _P + "volume_programs:ProgVolumeCenter",
    "volume_align": _P + "volume_programs:ProgVolumeAlign",
    "volume_subtraction": _P + "volume_programs:ProgVolumeSubtraction",
    "volume_segment": _P + "volume_programs:ProgVolumeSegment",
    "transform_mask": _P + "volume_programs:ProgTransformMask",
    "transform_symmetrize": _P + "volume_programs:ProgTransformSymmetrize",
    "volume_to_pseudoatoms": _P + "volume_programs:ProgVolumeToPseudoatoms",
    "volume_deform_sph": _P + "zernike_programs:ProgVolumeDeformSph",
    "volume_apply_coefficient_zernike3d":
        _P + "zernike_programs:ProgVolumeApplyCoefficientZernike3D",
    "volume_apply_deform_sph":
        _P + "zernike_programs:ProgVolumeApplyCoefficientZernike3D",
    "angular_sph_alignment": _P + "zernike_programs:ProgAngularSphAlignment",
    "forward_zernike_volume": _P + "zernike_programs:ProgForwardZernikeVolume",
    "forward_zernike_images": _P + "zernike_programs:ProgForwardZernikeImages",
    "forward_zernike_images_priors":
        _P + "zernike_programs:ProgForwardZernikeImagesPriors",
    "nma_modes": _P + "nma_programs:ProgNMAModes",
    "nma_alignment_vol": _P + "nma_programs:ProgNMAAlignmentVol",
    "pdb_nma_deform": _P + "nma_programs:ProgPDBNMADeform",
    "nma_alignment": _P + "flex_misc_ext:ProgNMAAlignment",
    "flexible_alignment": _P + "flex_misc_ext:ProgFlexibleAlignment",
    "forward_zernike_subtomos":
        _P + "flex_misc_ext:ProgForwardZernikeSubtomos",
    "art_zernike3d": _P + "flex_misc_ext:ProgArtZernike3D",
    "forward_art_zernike3d_subtomos":
        _P + "flex_misc_ext:ProgForwardArtZernike3DSubtomos",
    "cuda11_forward_art_zernike3d":
        _P + "flex_misc_ext:ProgCuda11ForwardArtZernike3D",
    "classify_FTTRI": _P + "flex_misc_ext:ProgClassifyFTTRI",
    "classify_CLTomo_prog": _P + "flex_misc_ext:ProgClassifyCLTomo",
    "volume_initial_simulated_annealing":
        _P + "flex_misc_ext:ProgVolumeInitialSimulatedAnnealing",
    "phantom_transform": _P + "flex_misc_ext:ProgPhantomTransform",
    "volume_to_web": _P + "flex_misc_ext:ProgVolumeToWeb",
    "resolution_pdb_bfactor": _P + "flex_misc_ext:ProgResolutionPdbBfactor",
    "performance_test": _P + "flex_misc_ext:ProgPerformanceTest",
    "write_test": _P + "flex_misc_ext:ProgWriteTest",
    "tomo_project": _P + "tomo_programs:ProgTomoProject",
    "project_tomography": _P + "tomo_programs:ProgTomoProject",
    "tomo_simulate_tilt_series":
        _P + "tomo_programs:ProgTomoSimulateTiltSeries",
    "tomo_extract_subtomograms":
        _P + "tomo_programs:ProgTomoExtractSubtomograms",
    "tomo_average_subtomos": _P + "tomo_programs:ProgTomoAverageSubtomos",
    "tomo_tiltseries_dose_filter":
        _P + "tomo_programs:ProgTomoTiltseriesDoseFilter",
    "tomo_detect_missing_wedge":
        _P + "tomo_programs:ProgTomoDetectMissingWedge",
    "tomogram_reconstruction": _P + "tomo_misc:ProgTomogramReconstruction",
    "tomo_detect_landmarks": _P + "tomo_misc:ProgTomoDetectLandmarks",
    "tomo_filter_coordinates": _P + "tomo_misc:ProgTomoFilterCoordinates",
    "tomo_map_back": _P + "tomo_misc:ProgTomoMapBack",
    "tomo_ctf_wiener2d_correction":
        _P + "tomo_misc:ProgTomoCtfWiener2DCorrection",
    "subtomo_subtraction": _P + "tomo_misc:ProgSubtomoSubtraction",
    "tomo_calculate_landmark_residuals":
        _P + "tomo_landmark_residuals:ProgTomoCalculateLandmarkResiduals",
    "tomo_detect_misalignment_residuals":
        _P + "tomo_landmark_residuals:ProgTomoDetectMisalignmentResiduals",
    "tomo_extract_particlestacks":
        _P + "tomo_landmark_residuals:ProgTomoExtractParticlestacks",
    "image_align_tilt_pairs": _P + "align_tilt_pairs:ProgAlignTiltPairs",
    "tomo_misalignment_resid_statistics":
        _P + "scripts_misc:ProgTomoMisalignmentResidStatistics",
    "image_peak_high_contrast": _P + "final_batch:ProgImagePeakHighContrast",
    "image_assignment_tilt_pair":
        _P + "final_batch:ProgImageAssignmentTiltPair",
    "metadata_xml": _P + "final_batch:ProgMetadataXML",
    "metadata_split_3D": _P + "final_batch:ProgMetadataSplit3D",
    "coordinates_noisy_zones_filter":
        _P + "final_batch:ProgCoordinatesNoisyZonesFilter",
    "volumeset_align": _P + "final_batch:ProgVolumesetAlign",
    "pdb_analysis": _P + "final_batch:ProgPDBAnalysis",
    "pdb_label_from_volume": _P + "final_batch:ProgPDBLabelFromVolume",
    "pdb_reduce_pseudoatoms": _P + "final_batch:ProgPDBReducePseudoatoms",
    "pdb_sph_deform": _P + "final_batch:ProgPDBSphDeform",
    "compare_density": _P + "final_batch:ProgCompareDensity",
    "ctf_correct_wiener3d": _P + "final_batch:ProgCTFCorrectWiener3D",
    "transform_adjust_volume_grey_levels":
        _P + "final_batch:ProgAdjustVolumeGreyLevels",
    "sync_data": _P + "infra_scripts:ProgSyncData",
    "compile": _P + "infra_scripts:ProgCompile",
    "test_script_importing_module":
        _P + "infra_scripts:ProgTestScriptImportingModule",
    "matlab_bridge": _P + "matlab_bridge:ProgMatlabBridge",
    "metadata_selfile_create": _P + "scripts_misc:ProgMetadataSelfileCreate",
    "pdb_center": _P + "scripts_misc:ProgPdbCenter",
    "pdb_select": _P + "scripts_misc:ProgPdbSelect",
    "coordinates_consensus": _P + "scripts_misc:ProgCoordinatesConsensus",
    "pick_noise": _P + "scripts_misc:ProgPickNoise",
    "preprocess_mics": _P + "scripts_misc:ProgPreprocessMics",
    "volume_consensus": _P + "scripts_misc:ProgVolumeConsensus",
    "cl2d_clustering": _P + "scripts_misc:ProgCl2dClustering",
    "align_pca_2d": _P + "scripts_misc:ProgAlignPCA2D",
    "graph_max_cut": _P + "scripts_misc:ProgGraphMaxCut",
    "extract_particles": _P + "scripts_misc:ProgExtractParticles",
    "swiftalign_wiener_2d": _P + "scripts_misc:ProgSwiftalignWiener2D",
    "swiftalign_aligned_2d_classification":
        _P + "scripts_misc:ProgSwiftalignAligned2DClassification",
    "deep_consensus": _P + "deep_programs:ProgDeepConsensus",
    "deep_micrograph_cleaner": _P + "deep_programs:ProgDeepMicrographCleaner",
    "deep_hand": _P + "deep_programs:ProgDeepHand",
    "deepRes_resolution": _P + "deep_programs:ProgDeepResResolution",
    "deep_global_assignment": _P + "deep_programs:ProgDeepGlobalAssignment",
    "deep_global_assignment_predict":
        _P + "deep_programs:ProgDeepGlobalAssignmentPredict",
    "deep_misalignment_detection":
        _P + "deep_programs:ProgDeepMisalignmentDetection",
    "deep_volume_postprocessing":
        _P + "deep_programs:ProgDeepVolumePostprocessing",
}

# the reference's aliases of these programs (programs/registry.py:177,
# :216, :260, :274, :305, :311-350, :360): alias -> the program it runs
ALIASES: dict[str, str] = {
    "ctf_correct_phase": "ctf_phase_flip",
    "cuda_movie_alignment_correlation": "movie_alignment_correlation",
    "cuda_reconstruct_fourier": "reconstruct_fourier",
    "reconstruct_fourier_accel": "reconstruct_fourier",
    "mpi_reconstruct_fourier": "reconstruct_fourier",
    "mpi_reconstruct_fourier_accel": "reconstruct_fourier",
    "mpi_cuda_reconstruct_fourier": "reconstruct_fourier",
    "mpi_angular_project_library": "angular_project_library",
    "mpi_angular_projection_matching": "angular_projection_matching",
    "mpi_ctf_correct_phase": "ctf_phase_flip",
    "mpi_ctf_correct_wiener2d": "ctf_correct_wiener2d",
    "mpi_ctf_sort_psds": "ctf_sort_psds",
    "mpi_transform_filter": "transform_filter",
    "mpi_transform_geometry": "transform_geometry",
    "mpi_transform_normalize": "transform_normalize",
    "mpi_classify_CL2D": "classify_CL2D",
    "mpi_ml_align2d": "ml_align2d",
    "mpi_mlf_align2d": "mlf_align2d",
    "mpi_classify_CL2D_core_analysis": "classify_CL2D_core_analysis",
    "mpi_angular_accuracy_pca": "angular_accuracy_pca",
    "mpi_image_operate": "image_operate",
    "mpi_image_resize": "image_resize",
    "mpi_transform_threshold": "transform_threshold",
    "mpi_reconstruct_art": "reconstruct_art",
    "mpi_reconstruct_wbp": "reconstruct_wbp",
    "mpi_reconstruct_significant": "reconstruct_significant",
    "cuda_align_significant": "align_significant",
    "mpi_angular_assignment_mag": "angular_assignment_mag",
    "mpi_angular_class_average": "angular_class_average",
    "mpi_angular_continuous_assign": "angular_continuous_assign",
    "mpi_angular_continuous_assign2": "angular_continuous_assign2",
    "mpi_angular_discrete_assign": "angular_discrete_assign",
    "mpi_continuous_create_residuals": "continuous_create_residuals",
    "mpi_multireference_aligneability": "multireference_aligneability",
    "mpi_subtract_projection": "subtract_projection",
    "mpi_validation_nontilt": "validation_nontilt",
    "cuda_angular_continuous_assign2": "angular_continuous_assign2",
    "mpi_image_eliminate_byEnergy": "image_eliminate_byEnergy",
    "mpi_image_rotational_pca": "image_rotational_pca",
    "mpi_image_sort": "image_sort",
    "mpi_image_ssnr": "image_ssnr",
    "mpi_run": "run",
    "cuda_volume_halves_restoration": "volume_halves_restoration",
    "mpi_transform_adjust_image_grey_levels":
        "transform_adjust_image_grey_levels",
    "mpi_transform_mask": "transform_mask",
    "mpi_transform_symmetrize": "transform_symmetrize",
    "cuda_volume_deform_sph": "volume_deform_sph",
    "cuda_angular_sph_alignment": "angular_sph_alignment",
    "mpi_angular_sph_alignment": "angular_sph_alignment",
    "mpi_forward_zernike_images": "forward_zernike_images",
    "mpi_forward_zernike_images_priors": "forward_zernike_images_priors",
    "mpi_nma_alignment_vol": "nma_alignment_vol",
    "mpi_nma_alignment": "nma_alignment",
    "mpi_forward_zernike_subtomos": "forward_zernike_subtomos",
    "mpi_classify_FTTRI": "classify_FTTRI",
    "mpi_classify_CLTomo_prog": "classify_CLTomo_prog",
    "mpi_performance_test": "performance_test",
    "mpi_write_test": "write_test",
    "mpi_subtomo_subtraction": "subtomo_subtraction",
    "mpi_volumeset_align": "volumeset_align",
    "alignPCA_2D": "align_pca_2d",
    "deep_res_resolution": "deepRes_resolution",
}
_REGISTRY.update({alias: _REGISTRY[name] for alias, name in ALIASES.items()})


def get_program(name: str):
    """Instantiate a program class by CLI name (lazy import)."""
    import importlib

    if name not in _REGISTRY:
        return None
    module, _, cls = _REGISTRY[name].partition(":")
    return getattr(importlib.import_module(module), cls or "PROGRAM")()


def list_programs() -> list[str]:
    return sorted(_REGISTRY)


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0])
    if prog.startswith("xmipp_"):
        name, args = prog[len("xmipp_"):], argv[1:]
    else:
        if len(argv) < 2 or argv[1] in ("-h", "--help"):
            print("Usage: python -m xmipp3_tpu_torch.programs <program> "
                  "[options]\n\nAvailable programs:")
            for p in list_programs():
                print(f"  xmipp_{p}")
            return 0
        name, args = argv[1], argv[2:]
        if name.startswith("xmipp_"):
            name = name[len("xmipp_"):]
    program = get_program(name)
    if program is None:
        print(f"xmipp: unknown program '{name}' (try --help)",
              file=sys.stderr)
        return 1
    from xmipp3_tpu_torch.core.errors import XmippError
    try:
        program.read(["xmipp_" + name] + args)
    except XmippError as e:
        print(f"XMIPP_ERROR: {e}\nRun 'xmipp_{name} --help' for usage.",
              file=sys.stderr)
        return 1
    return program.tryRun()
