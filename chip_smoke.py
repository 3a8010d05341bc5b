#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xmipp3_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result line is printed:

1. Device and build: the card's name and power limit (nvidia-smi), the
   nvcc build of every kernel in xmipp3_tpu_torch/csrc/ and its seconds.
2. Kernel vs plain at the main path's shapes: N=128, P=256, one 256-image
   batch of slice samples from random poses (M = 1,661,440 samples) for the
   gridding kernels; for the multi-stream scatter that batch's 160 tap
   streams under the wide blob of phase 3, made as the main path makes them
   (and, as a side reading, its 8 trilinear tap streams); ring FFTs of
   noise at B=512 images, 31 rings,
   R=1652 references and 64 harmonics for the cross-spectrum. Each kernel
   is held against its plain PyTorch version on the same inputs
   (max |kernel - plain| / max |plain| <= 1e-4 for the scatters, whose
   atomics add in another order; <= 1e-5 for the cross-spectrum, whose sums
   run in a fixed order) and timed with CUDA events beside its plain
   version, its bound and the PyTorch calls that compute the same
   (`index_add_` per channel on the expanded tap stream for the scatters,
   two complex einsums for the cross-spectrum). The scatters also get their
   bound counted in 32-byte sectors (what the atomics move between L2 and
   device memory), their channel adds per second and the wrapper's host
   microseconds per call; K1 is also timed on K5's tap streams flattened,
   beside K5 on them stacked.
3. End to end through the CLI: an analytic Gaussian phantom's projections
   at N=128 (10,000 views, the repo's headline reconstruction workload;
   uniform on the sphere, random psi, small shifts) are
   written as an .mrcs stack with an .xmd, and
   `python -m xmipp3_tpu_torch.programs reconstruct_fourier` runs
   in-process on the card with --interp kb, tri+kb and nn, and with a blob
   wider than the kb kernel's footprint (--blob 2.5 0 10), whose taps go
   through the multi-stream scatter. Every kernel's launch count is set to
   0 before each run and read after it; the run's kernel must have
   launched. The map must agree with the phantom: FSC >= 0.9 up to half
   Nyquist for kb and tri+kb, real-space correlation >= 0.9 for nn and the
   wide blob.
4. The cycle through the CLI: an 8-blob phantom at N=128 ->
   angular_project_library --sampling_rate 5 (1652 directions) -> 10,000
   analytic views (uniform on the sphere, random psi, shifts of +-3 px,
   noise of 0.5 sigma; numpy's draws, the views evaluated on the card, as
   phase 3's) -> angular_projection_matching --max_shift 4
   --batch 512 -> reconstruct_fourier on the assigned poses. The launch
   counts are set to 0 before each program. The cross-spectrum kernel must
   have launched in the matching run (13 trial shifts x 20 batches); >= 90 %
   of the views must be assigned within 7.5 degrees of their true direction
   (the antipode with a flip is the same view), the median shift error must
   be <= 0.5 px and the closing map must correlate >= 0.8 with the phantom.
   Its FSC curve, the 0.143 resolution that the port's resolution_fsc
   program reads against the phantom, and the matching run's per-phase
   seconds are printed.
   Phase 2 also holds the Kaiser-Bessel kernel's kz-slab mode: the batch
   gridded into two slabs of 128 planes (z_lo 0 and 128), each against its
   plain version (1e-4 * max), then both into views of one allocation
   against the full-cube kernel (1e-4 * max), with each slab's bounds and
   `index_add_` on the slab's taps as the library time.
5. The mesh paths through the CLI on the one card: the ranks of a gloo
   process group, each a process of its own on cuda:0, started with
   --dist_coordinator 127.0.0.1:<free port> --dist_nprocs n --dist_procid
   r, on the data of phases 3 and 4. reconstruct_fourier --interp kb with
   --mesh slab (2 ranks), slab2d (4 ranks, 2 x 2) and dp (2 ranks): each
   volume must equal phase 3's serial kb volume to 1e-4 * max and keep
   FSC >= 0.9 to half Nyquist, and every rank of a slab run must have
   launched the kb kernel in slab mode. angular_projection_matching at
   phase 4's flags with --mesh dp and tp (2 ranks): each must assign >= 99 %
   of the views to the same direction as phase 4's serial run (within
   0.1 degrees, a flipped match naming the antipode), and every
   rank must have launched the cross-spectrum kernel. A rank that fails, or
   a run longer than RANK_TIMEOUT_S, fails the script. One line a run
   gives its wall and every rank's wall and phase seconds.
6. The CTF-corrected cycle through the CLI, on phase 4's clean views, poses,
   phantom and gallery, at 2 A/px: 20 micrographs of 500 views, each with
   its own CTF (300 kV, Cs 2.7 mm, Q0 0.1, defocusU evenly over
   8,000-20,000 A, defocusV 300 A more, azimuths evenly over [0, 180)),
   planted with a numpy expression (plant_ctf) that the port's
   CTFDescription.generate_2d must equal to CTF_TOL * max; noise of 0.5
   sigma after the CTF. Metadata with a ctfModel column (20 .ctfparam
   files) and with inline ctf* labels. Every --useCTF reconstruction runs
   at --minCTF 0.1 (CTF_MIN). (a) reconstruct_fourier --useCTF
   --sampling 2 (kb) on the clean CTF views at their true poses: FSC >= 0.9
   against the phantom to half Nyquist, and better than the same run
   without --useCTF. (b) ctf_phase_flip on the noisy views ->
   angular_projection_matching --phase_flipped --ctf <middle micrograph>
   --max_shift 4 --batch 512 against phase 4's gallery ->
   reconstruct_fourier --useCTF --phaseFlipped --sampling 2 --prepare_fsc
   -> resolution_fsc on the halves and against the phantom: phase 4's
   limits (>= 90 % within 7.5 degrees, median shift error <= 0.5 px, a
   closing map correlation >= 0.8, CYCLE_CTF_MAP_CORR). The phase-flipped
   views are also
   rebuilt at their true poses: the closing map's ceiling. (c) ctf_correct_wiener2d --pad 2 on
   512 noisy views: closer to the clean views than the raw ones. The kb
   kernel must launch 40 times in each reconstruction, the cross-spectrum
   13 x 20 times in the matching. A `ctf {...}` line gives each program's
   wall, phases, untimed rest, launches and peak memory, the quality, and
   the card's milliseconds for the CTF table of a batch, a batch's per-row
   CTFs and its phase flip.
7. BASELINE config 1 through the CLI at N=128: one view of the 8-blob
   phantom at rot 30, tilt 60 is the clean reference; 10,000 analytic
   views of it are evaluated on the card (psi uniform on [0, 360), shifts
   uniform in +-6 px, half mirrored in x, noise of 0.5 sigma of the clean
   view, drawn with numpy; the truth is kept out of the rows) ->
   transform_filter --fourier low_pass 0.25 -> transform_normalize
   --method NewXmipp --background circle 56 -> image_align --ref <clean>
   --max_shift 8 --oaligned -> transform_geometry --apply_transform of its
   rows (B-spline) -> reference-free image_align --iter 3. Checks: the
   filter within 1e-4 * max of a numpy rfft low-pass on 64 views; the
   normalised background's mean within 0.05 of 0 and std within 0.05 of 1;
   against the truth, mirror flags right for >= 99 %, psi within 2 degrees
   for >= 95 % and a median shift error <= 0.5 px; transform_geometry's
   average correlates >= 0.99 with image_align's own aligned average, each
   >= 0.9 with the clean view, as does the reference-free average once
   registered to it. An `align2d {...}` line gives each program's wall,
   images/s, phases, untimed rest and peak device memory, and the quality.
   No kernel runs in it. Its files are removed when it ends.
8. BASELINE config 2 through the CLI at a 4k frame's size: micrograph A
   (4096 x 4096 at 1.34 A/px, 300 kV, Cs 2.7 mm, Q0 0.07; defocus 18,000 /
   16,000 A at 35 degrees) and micrograph B (8 x 8 blocks of 512 x 512,
   each with the defocus of a tilted plane at its centre, mean 15,000 A,
   +1,500 A across x and -800 A across y, A's astigmatism), each complex
   white noise times the CTF with its envelope plus the background model
   of the reference's synthetic PSDs, made with numpy from --seed ->
   ctf_estimate_from_micrograph on A (micrograph mode), on B --mode
   regions (16 interior regions at --skipBorders 2), on A --mode particles
   (300 positions from --seed); ctf_estimate_from_psd and
   ctf_estimate_from_psd_fast on A's .psd; psd_estimate on A;
   ctf_enhance_psd on A's .psd; ctf_sort_psds on A's outputs; ctf_group
   --wiener on phase 6's 20 micrograph CTFs. Checks: A's PSD within 1e-4 *
   max of a float64 numpy periodogram of the same tiles; A's defocusU and
   defocusV within 2 % of the plant and its azimuth within 5 degrees (so
   for from_psd), the 1-D fit within 5 % of the mean defocus; each region
   within EST_REGION_TOL of its block, the plane at B's centre within
   EST_PLANE_TOL, each particle within EST_PARTICLE_TOL of A's defocus
   (limits planned with tools/plan_ctf_estimate.py); every other output
   finite and of its shape. A `ctfest {...}` line gives each program's
   wall, phases, untimed rest, compass seconds and rounds, fitness and
   peak device memory, and the quality. No kernel runs in it.
9. BASELINE config 5 through the CLI: phantom_movie -size 4096 4096 40
   (the program's default 4k frame, with ice, dose and barrel distortion
   at its defaults, from --seed) -> movie_alignment_correlation with its
   defaults (local alignment on 7 x 7 patches, --patchesAvg 3, --oavg,
   --oavgInitial) -> the same with --skipLocalAlignment --dose_per_frame 1
   --oaligned -> the same with --mesh dp over 2 gloo ranks on the card ->
   movie_filter_dose; a second phantom movie (16 frames at a dose of 30)
   with per-column and per-row gain defects planted in numpy ->
   movie_estimate_gain --frameStep 4. Then two 256^3 half maps at 1 A/px
   (white noise in a sphere, zones low-passed to 3, 5 and 8 A, noise per
   half; numpy) -> resolution_monogenic_signal --vol --vol2 --mask,
   resolution_monotomo on their central 64 planes, resolution_fso on an
   isotropic and an anisotropic pair, resolution_localfilter,
   volume_correct_bfactor, volume_structure_factor and
   resolution_directional. Checks: the global positions against the
   _gt.xmd truth (median and worst), the aligned average's power in the
   scene's band over the initial one's, the two global runs' positions
   equal, the mesh field within 1e-3 px of the serial one, the dose filter
   within 1e-4 * max of numpy, the gain estimate's correlation with the
   planted inverse gain, MonoRes's median per zone against its plant, the
   FSO's spread for each pair, the directional map finer in the inner
   zone than in the outer; every output finite and of its shape (limits
   planned with tools/plan_movie_monores.py). A `movie {...}` line gives
   each program's wall, phases, untimed rest and peak device memory, and
   the quality. No kernel runs in it.
10. BASELINE config 4's CL2D half through the CLI at N=128: 4,096 views
   (two of CL2D's 2,048-image match chunks, one for each rank of its mesh
   run; the limits were planned on 2,000) of 16 directions of phase 4's
   5-degree gallery chosen far apart (farthest-point sampling, a direction
   and its antipode one view), 256 each, of the 8-blob phantom, each with psi uniform, shifts in +-4 px,
   half mirrored, and noise of 1 sigma of the class images (numpy recipe,
   rendered on the card); the planted registration is written as
   image_align writes one, and it must undo the plant. classify_CL2D
   --nref 16 --nref0 4 --iter 10, serially and with --mesh dp over 2 gloo
   ranks; classify_CL2D_core_analysis --computeCore 3 2 and
   --computeStableCore 1; ml_align2d --nref 16 --mirror --iter 10,
   serially and with --mesh dp; mlf_align2d the same on the views through
   4 planted CTFs at 2 A/px; classify_kerdensom --xdim 7 --ydim 7 on each
   view's rotational spectrum; angular_accuracy_pca --ref the phantom on
   the planted poses with 5 % of the rows moved by 15 degrees. Checks,
   with limits planned by tools/plan_classify.py: purity and directions
   won (CL2D, ML2D, MLF2D), the mesh runs against the serial ones, every
   core a subset of its classes and as pure, a stable core, the LL rising
   without a dip, the class averages against their clean image, the
   SOM's node purity, the moved rows' AUC, K4 launched in the CL2D and ML
   runs; every output finite and of its shape. K4 is held against its
   plain version at ML2D's shape (1024, 61, 32, 257, no mirror) and timed
   beside the plain version and the complex einsum. A `classify {...}`
   line gives each program's wall, phases, untimed rest and peak device
   memory, and the quality.
11. The image and metadata utilities, ART, SIRT and WBP, align_significant
   and reconstruct_significant through the CLI. (a) On the first 2,000 of
   phase 4's views (the checks against numpy hold at any count):
   transform_window to 160 and back, image_resize --fourier 64,
   image_convert to a Spider stack and back, image_operate --plus then
   --mult, transform_add_noise --seed 0, transform_threshold,
   transform_mirror, transform_randomize_phases, image_statistics,
   image_histogram and image_header; transform_downsample --step 2 on
   phase 8's micrograph A (remade from the seed); on phase 4's 10,000
   assignment rows: metadata_utilities (sort, query, union, fill),
   metadata_split, metadata_histogram, angular_distance against the true
   poses (it must agree with phase 4's own count), angular_rotate and its
   inverse, and the EMX round trip. Checks against numpy on the host:
   exact for the window, convert, operate, threshold, mirror and
   histogram and every metadata program; <= 1e-4 * max for the resize,
   the noise (the same Generator(0) draws), the randomised phases'
   amplitudes and kept band and the downsample; the statistics <= 1e-5
   relative to float64; the rotation and its inverse within 1e-3 degrees.
   (b) On phase 3's 10,000 true-pose views: reconstruct_art --parallel_mode
   pSART --block_size 1000 -n 2 (K2, 20 launches), --parallel_mode SIRT
   -n 3 --POCS_positivity (K2, 3), reconstruct_wbp --filsam 5 and
   --diameter 96 (K3, 1 each); each map's correlation with the phantom
   against the limits tools/plan_reconstruct_misc.py planned, and ART's
   residual histories never rising. K2 is held against its plain version
   at one pSART block's samples and at a SIRT pass's (every view in one
   launch), K3 at WBP's one launch of every view (its plain version and
   tap count in parts of 4M samples), each to 1e-4 * max, and timed
   beside it. (c)
   align_significant --angDistance 10 --max_shift 4 against phase 4's
   gallery, serially (K4, 13 trials x 20 chunks) and with --mesh dp over 2
   gloo ranks (torchrun's environment): >= 90 % of the views within 7.5
   degrees of their direction, the mesh weights within 1e-5 * max of the
   serial ones. (d) reconstruct_significant --initvolumes (the 8-blob
   phantom low-passed to a quarter of Nyquist) --angularSampling 5 --iter
   3 --maxShift 4 on 256 low-noise views of the phantom (K3 3, K4 39
   launches): the map's correlation with the phantom against its planned
   limit. A `recmisc {...}` line gives each program's wall, phases, untimed
   rest, launches and peak device memory, and the quality.
12. Phantoms and projection, continuous and discrete angular assignment,
   class averages, subtraction, residuals, SSNR and common lines through
   the CLI. (a) phantom_create from a .descr of six features (128^3) ->
   phantom_project --nangles 2000 --xdim 128 (planned on 1,000), Fourier
   and --method real_space; phantom_project on a synthetic model of 300
   atoms
   (write_pdb; --xdim 64 --sampling_rate 2 --high_sampling_rate 1);
   phantom_simulate_microscope with a CTF, and with a CTF and --noise.
   Checks: the Fourier views against FourierProjector (1e-5 * max), the
   real-space views' correlation with them, the PDB views' sums equal,
   the CTF and the noise against numpy (the same Generator's draws). (b)
   Phase 4's assignment (flipped rows turned into their unflipped poses)
   -> angular_continuous_assign2 --optimizeAngles --optimizeShift, the
   same with --optimizeGray and angular_continuous_assign --optimizeShift,
   each on the first 2,000 views (planned on 1,000): median rotation and
   shift
   errors against the truth, no larger than phase 4's on the same views
   and than the planned limits, and the mean cost no lower at the last
   step than at the first. (c)
   angular_discrete_assign (--shift_step 2, 3 orientations a view, every
   gallery direction kept by the wavelet preselection and every in-plane
   angle searched; its defaults on 2,000 views, read only) and angular_assignment_mag
   --refVol -angleStep 5 on phase 4's views: >= 90 % within 7.5 degrees,
   K4 launched. (d) angular_class_average --split, serially and with
   --mesh dp over 2 gloo ranks: the averages' median correlation with
   their gallery image, the mesh averages and halves within 1e-5 * max of
   the serial ones. (e) subtract_projection on phase 6's CTF views at their
   true poses: the energy left inside r < 0.45 N; image_residuals on the
   first 2,000 of the results. (f) multireference_aligneability --sampling 5 (K4 in 20 chunks
   of 512 views) and validation_nontilt on 2,000 views' discrete clouds:
   the median accuracy weight and the score. K4 is held against its plain
   version at the aligneability shape (512, 61, 1652, 257, no mirror) and
   timed beside the plain version and one complex einsum. (g)
   angular_neighbourhood, angular_break_symmetry --sym c4,
   angular_estimate_tilt_axis on planted coordinate pairs, compare_views of
   the phantom and phase 4's map, resolution_ssnr (with --gen_VSSNR) on
   2,000 noisy unshifted views, continuous_create_residuals on 2,000 views
   and angular_commonline on 24 views at 64 px: each output's shape,
   finiteness and one quality number. Limits planned with
   tools/plan_angular.py. An `angular {...}` line gives each program's
   wall, phases, untimed rest, launches and peak device memory, and the
   quality.
13. Image and class analysis through the CLI. (a) Two states of the
   8-blob phantom (its fifth blob moved 6 px along y in the second),
   1,000 noisy views of each at known poses (phase 4's recipe; the angles
   in the rows) -> classify_first_split (its defaults, --Nrec 100
   --Nsamples 8, with --mask a sphere about the moved blob; K3 101
   launches: the average and one a subset) and
   classify_first_split3 (K2 twice a sweep and twice for the final
   halves): |corr(pc1, the planted difference)|, v1 and v2 closer to
   different states, the share of views in their state's half. (b) Phase
   4's views at their true poses, even and odd, gridded into two half maps
   (K3) -> volume_halves_restoration --denoising 1 --deconvolution 2
   --filterBank 0.02 0.5 1 3 --difference 1, serially and with --mesh dp
   over 2 gloo ranks: the restored map closer to the phantom than the
   halves' average, the mesh filter bank within 1e-5 * max of the serial
   one. (c) volume_find_symmetry --sym rot 4 on a C4 copy of the 8-blob
   phantom (64^3) about a planted axis (rot 33, tilt 52): within one
   5-degree step; --sym helical on a helix of 15 blobs (rise 9 A at 2
   A/px, twist 40 degrees): both within one step. (d) On the first 2,000
   of phase 4's views, mean-free, 1 % of them at 3 x contrast, plus 500
   noise-only images: image_eliminate_empty_particles -t 5 (empties
   eliminated, particles kept), image_sort_by_statistics and
   image_eliminate_byEnergy (the outliers' AUC), image_find_center on
   1,000 views moved by (3, -2) px (the error), image_ssnr (the median),
   image_sort on 200 views (the chain's median neighbour correlation);
   image_vectorize -> matrix_dimred on 1,000 of phase 10's views
   registered by their planted poses at 32^2 (PCA against numpy's float64
   SVD to 1e-4; LTSA: the share nearest their direction's centroid);
   image_rotational_pca --eigenvectors 8 --psi_step 90 on 2,000 views at
   64^2 (the serial path's exact SVD), serially and with --mesh dp over 2
   ranks (each principal angle <= 1e-3 rad; the share of the variance the
   basis holds), and serially at the default --psi_step 15 (above 4e7
   values: the randomised sketch; its share of the expanded data's
   variance over the exact eigenbasis's share). (e) On phase 10's CL2D output:
   classify_extract_features with every extractor (finite, each family's
   spread), classify_evaluate_classes, classify_analyze_cluster on class
   1, classify_compare_classes of the serial and the mesh hierarchy
   (every class paired), denoising_tv on 512 of phase 4's views (closer
   to the clean views than the raw), run -j 2 on four port commands and
   on a file with a failing command (rc 1). Limits planned with
   tools/plan_analysis.py. An `analysis {...}` line gives each program's
   wall, phases, untimed rest, launches and peak device memory, and the
   quality. K3 at one first_split subset (8 views) and K2 at one
   first_split3 half set (every view weighted 0 or 1) are held against
   their plain versions and timed with the wrapper's host microseconds.
14. Micrograph picking, the misc programs and the volume programs through
   the CLI; none may launch a kernel. (a) Two 4096^2 micrographs at 1.34
   A/px (BASELINE config 2's frame), each with 300 views of the 8-blob
   phantom at N=128 (uniform directions) at distinct cells of a 136 px
   grid (one box apart at least) and white noise of 1 sigma of the views
   (numpy; the views rendered on the card) -> micrograph_scissor at the
   first micrograph's positions (against a numpy crop: exact) and
   --extractNoise 300 (no noise box on a particle);
   micrograph_automatic_picking --ref (16 template views) --max_peaks 400
   on the first, --trainSVM on the scissor's particle and noise boxes and
   --svm on the second, --mode buildinv on the first with its positions,
   --mode train and --mode autoselect on the second: recall and precision
   within a quarter box against the planted positions. (b)
   transform_dimred on 1,000 of phase 10's views registered by their
   planted poses at 32^2 (--distance Euclidean PCA against numpy's float64
   SVD to 1e-4; the default Correlation distance: the share of views
   nearest their direction's centroid); on the first 2,000 of phase 4's
   views (its clean views with new noise of 0.5 sigma, its true poses):
   image_odd_even with --sum_frames and angular_distribution_show
   --sampling 10 against numpy; transform_adjust_image_grey_levels on
   their FourierProjector views with a planted a = 1.03, b = 0.02 sigma
   (--max_resolution 2): a and b recovered; transform_center_image on
   the unshifted views and on a copy moved by planted shifts (the
   difference of the two runs' shifts against the plant);
   transform_morphology --binaryOperation dilation --size 2 against
   scipy.ndimage (exact); local_volume_adjust on the 256^3 phantom with
   one 32^3 block scaled by 1.5 (the occupancy and the output against the
   plant); volume_local_sharpening -k 1 on a 256^3 density of blobs
   blurred by 2 px with a two-zone resolution map (3 A, 8 A): finite, and
   its energy above 0.2 cycles/px lifted more against the 0.08-0.15 band
   in the fine zone than in the coarse one. (c) At 64^3: volume_from_pdb on phase 12's
   300-atom model (and --high_sampling_rate 1) against the sums the
   reference gave on the same model; volume_center on a planted shift;
   volume_align on a planted rotation (30, 20, 0) and shift by its grid
   (10-degree, 1 px steps), --local and --frm, each within one grid step;
   volume_subtraction --sub of the phantom without one of its blobs (the
   removed blob's energy recovered, the rest small); volume_segment
   (Otsu; its mask against numpy); transform_mask --mask circular -20
   against numpy (exact); transform_symmetrize --sym c4 on a noisy C4 map
   about z (closer to the clean one); volume_to_pseudoatoms --sigma 1
   --targetError 1 (it reaches the target). Limits planned with
   tools/plan_volume_misc.py. A `misc {...}` line gives each program's
   wall, phases, untimed rest, launches and peak device memory, and the
   quality.
15. Zernike3D and NMA flexibility through the CLI. (a) The 8-blob
   phantom at 128^3 deformed by planted Zernike3D coefficients (L1=3,
   L2=2: 13 x 3) -> volume_deform_sph --analyzeStrain (its NCC and the
   RMS error of the fitted displacement field over the phantom's mass),
   volume_apply_coefficient_zernike3d with the planted coefficients
   (against the script's warp, 1e-4 * max), forward_zernike_volume. (b)
   16 views at 128^2 of the phantom, each deformed by its own planted
   coefficients, at phase 4's first poses, with the CTFs of phase 6's
   recipe at 2 A/px and noise; the rows' angles and shifts a little off
   -> angular_sph_alignment, serially and with --mesh dp over 2 gloo ranks
   (the mesh rows within FX_MESH_TOL of the serial ones),
   forward_zernike_images --useCTF and forward_zernike_images_priors from
   its output: the mean CC, the coefficients' relative error and the
   median pose error. (c) Phase 12's 300-atom model -> nma_modes
   --nmodes 3 -> pdb_nma_deform with planted amplitudes (exact) ->
   nma_alignment_vol (the amplitudes recovered), and models.nma's
   fit_mode_amplitudes by Adam and by COBYQA on the card; 8 views of the
   model deformed by their own amplitudes -> nma_alignment, with
   --projMatch (K4) and flexible_alignment: the amplitudes' RMS error and
   the mean CC. (d) 8 wedge-masked subtomograms at 64^3 ->
   forward_zernike_subtomos; 8 of two states ->
   forward_art_zernike3d_subtomos --useZernike --clusters 2; 2 x 400
   views of two states at 128^2 with CTFs -> art_zernike3d and
   cuda11_forward_art_zernike3d --ltk --ltv (--useZernike --useCTF
   --clusters 2; K3): each map's correlation with the phantom, and the
   clusters splitting the states. Only the ART programs and --projMatch
   may launch a kernel. Limits planned with tools/plan_flex.py. K3 is
   held against its plain version at one art_zernike3d pass (a cluster's
   400 views), K4 at one trial of --projMatch's scan. A `flex {...}` line
   gives each program's wall, phases, untimed rest, launches and peak
   device memory, and the quality.
16. Tomography, the tail of flex_misc_ext and three tilt programs through
   the CLI. (a) 40 particles of the two states of phase 13 (the 8-blob
   phantom in a 64^3 box) at rows' random poses on a grid in a 512 x 512
   x 128 tomogram, 12 gold beads of 80 A at 8 A/px between them ->
   tomo_simulate_tilt_series (41 images of 512^2 over +-60 degrees, a run
   a state with its beads and noise in the first, summed) ->
   tomo_tiltseries_dose_filter (against numpy), tomo_detect_landmarks
   (recall and precision within 3 px of the planted beads in each image),
   tomo_calculate_landmark_residuals (their rms),
   tomo_detect_misalignment_residuals (the share of images enabled),
   tomo_misalignment_resid_statistics (against numpy);
   tomogram_reconstruction --thickness 128 (K3, one launch) of the series
   with each image transposed (the program tilts about x, the simulator
   about y: ROADMAP.md section 3, item 25), its correlation with the
   truth below 0.1 cycles/px once back in the truth's frame ->
   tomo_detect_missing_wedge and image_peak_high_contrast on the whole
   reconstruction (both fitted planes and the beads found against what
   the reference's programs read on the card's reconstruction: neither
   plane is an edge of the wedge and none of the 12 is a bead,
   ROADMAP.md section 3, items 26-27), image_peak_high_contrast on the
   simulated tomogram (recall and precision against the planted beads),
   tomo_filter_coordinates
   (against numpy), tomo_extract_subtomograms --invertContrast,
   tomo_average_subtomos of the first state (its correlation with the
   particle), tomo_map_back --method highlight (the painted mass),
   subtomo_subtraction --sub on 4 subtomograms (the energy left),
   tomo_ctf_wiener2d_correction of the series through planted CTFs
   (closer to the series than the raw), tomo_project (against
   FourierProjector), tomo_extract_particlestacks (each patch against a
   numpy crop). (b) classify_CLTomo_prog --nref 2 on 1,000 wedge-masked
   subtomograms at 64^3 of the two states (purity); classify_FTTRI --nref
   16 on 2,048 views of phase 10's recipe (purity and directions won),
   serially and with --mesh dp over 2 gloo ranks (the same classes). (c)
   volume_initial_simulated_annealing at its defaults on 1,000 of phase
   4's views (K3 in its SIRT passes, K4 in its greedy matching) ->
   volume_align --frm --consider_mirror: the map's correlation with the
   phantom. (d) image_assignment_tilt_pair on 200 planted 0/45-degree
   pairs with 20 spare points (recall, precision), image_align_tilt_pairs
   on 200 tilted views with planted shifts (the shift error, the share
   enabled), phantom_transform of phase 12's 300-atom model (against
   numpy), volume_to_web (against numpy), resolution_pdb_bfactor on a
   radial resolution map (against numpy), performance_test and
   write_test (their figures). Only the reconstruction and the annealing
   may launch a kernel. Limits planned with tools/plan_tomo.py. K3 is
   held against its plain version at the tomogram's launch (41 views at
   N=512, P=1024; the plain version and the tap count in parts of 4 M
   samples), K4 at one trial of the annealing's greedy scan. A `tomo
   {...}` line gives each program's wall, phases, untimed rest, launches
   and peak device memory, and the quality.
17. The long tail through the CLI: the 39 endpoints of the deep programs,
   the rest of final_batch and scripts_misc, matlab_bridge and the infra
   programs, all but sync_data (a network fetch), and compile only where
   the host has g++; no kernel may launch in it. (a) The deep programs
   train with --train on numpy recipes and score held-out data:
   deep_consensus on 500 particle and 500 noise boxes at 64^2 (views of
   the 8-blob phantom, noise of 1 sigma; 10 epochs; 1,000 candidates
   scored), deep_global_assignment on 1,000 views at 64^2 without psi or
   shifts (15 epochs) and _predict on 500 more (the median angular
   error), deep_micrograph_cleaner on a 4096^2 micrograph of phase 14's
   recipe with a 1,024-column carbon strip (250 + 250 training patches,
   10 epochs; --boxSize 64; the mask's pixel accuracy), deep_hand on 4
   random blob sets at 64^3 x 8 augmentations (10 epochs; a held-out set
   and its mirror),
   deepRes_resolution on 8 maps at 64^3 low-passed to 3-10 A (--patch 16)
   applied to a 128^3 map of two zones (4 and 8 A; each zone's median),
   deep_misalignment_detection on 400 + 400 subtomograms at 32^3 (aligned
   within 1 px, or turned; held-out accuracy), deep_volume_postprocessing
   on 4 blurred, noisy pairs at 64^3 applied to a 128^3 map (its
   correlation with the clean map, above the input's). Each trained
   model's predictions on the card are held against the port's CPU
   forward on the same weights (1e-4 * max). (b) compare_density of a blob
   and the blob with a satellite at 128^3 (--degstep 10),
   ctf_correct_wiener3d of two CTF groups of the 8-blob map at 128^3,
   transform_adjust_volume_grey_levels --optimize on 500 planted views
   (a, b recovered), volume_consensus of three noisy copies,
   volumeset_align of 8 maps at 64^3 turned by planted rotations on its
   --step 30 grid, the PDB programs on phase 12's 300-atom model (against
   scipy and numpy), a 4096^2 micrograph of phase 14's recipe with a noisy
   band through coordinates_noisy_zones_filter, coordinates_consensus,
   pick_noise, preprocess_mics (against numpy), extract_particles (against
   numpy crops), metadata_selfile_create and metadata_xml;
   swiftalign_wiener_2d (against numpy) and
   swiftalign_aligned_2d_classification on 2,000 views of 16 directions
   at 64^2, cl2d_clustering on 64 class averages, align_pca_2d on 2,000
   views of one direction, metadata_split_3D, graph_max_cut on two planted
   communities of 200 nodes; every matlab_bridge function at 128^2 and
   64^3 (those that run on the card also with --device cpu: 1e-4 * max,
   align2d's pose to 0.05), test_script_importing_module and compile.
   Limits planned with tools/plan_tail.py. A `tail {...}` line gives each
   program's wall, phases, untimed rest, launches and peak device memory,
   and the quality.
18. The binding surface, driven as a Scipion protocol drives it: the
   port's xmippLib, xmipp_base and xmippPyModules (binding/), with the
   launch counts at 0 around each call and no kernel allowed to launch.
   (a) FourierProjector on phase 4's 8-blob phantom (padding 2: a 256^3
   cube), one projectVolume for each of the 1,652 directions of phase 4's
   5-degree gallery, held against the port's batched project_euler at the
   same angles (1e-5 * max); projectVolumeDouble at 16 of them, against
   those views by phase 12's median-correlation limit. (b) readApplyGeo on
   1,000 rows of phase 4's assignment and applyCTF (the method and the
   function, in turns) on a view of each of phase 6's 20 CTFs, each against
   the port's batched read_apply_geo / apply_ctf on the same images (1e-5
   * max); the CTF error functions and getPSF against device="cpu". (c)
   image_align on 64 pairs of phase 7's recipe (clean view, planted view):
   each aligned image registered back onto the clean view must hold phase
   7's limits (psi within 2 degrees for >= 95 %, median shift <= 0.5 px,
   no mirror left). (d) The four preview filters and
   fastEstimateEnhancedPSD on phase 8's 4096^2 micrograph A (which phase 8
   keeps) at dim 512, against device="cpu" (1e-4 * max). (e) swiftalign (the affine
   matrices and warp, InPlaneTransformCorrector, the CTF image,
   aligned_2d_classification) and bnb_gpu's band projections of the 16
   clean views and trial-grid match on 2,000 views of those 16 directions
   at 64^2, against device="cpu" (1e-4 * max; >= 99 % of the classes and
   matches the same). The device="cpu" runs of (d) and (e) go to a worker
   thread at the phase's start and overlap the card's calls. (f) Started
   first, an XmippScript in a process of its own, with binding/site on
   PYTHONPATH, projects the phantom: its result must come from the card,
   equal the in-process view (1e-5 * max), and neither jax, xmipp3_tpu nor
   the root xmippLib, xmipp_base or xmippPyModules may be loaded in it. A
   `binding {...}` line gives each call's wall, ms a call, launches and
   peak device memory, and the quality.
19. A line {"kernels": [...]} (K4 at ML2D's shape as cross_spectrum_ml2d,
   with phase 10's ML2D launches; K2 at a pSART block and a SIRT pass as
   tri_scatter_art_block and tri_scatter_sirt_pass, K3 at WBP's launch as
   kb_scatter_3ch_wbp, with phase 11's pSART, SIRT and WBP launches; K4 at
   the aligneability shape as cross_spectrum_aligneability, with phase
   12's aligneability launches; K3 and K2 at the first splits' shapes as
   kb_scatter_3ch_first_split and tri_scatter_first_split3, with phase
   13's launches; K3 at an art_zernike3d pass and K4 at a --projMatch
   trial as kb_scatter_3ch_art_zernike3d and cross_spectrum_nma_projmatch,
   with phase 15's launches; K3 at the tomogram's launch and K4 at an
   annealing trial as kb_scatter_3ch_tomogram and
   cross_spectrum_initial_volume, with phase 16's launches) and, last,
   {"ok": true, "device": {...}}.

It needs one card and the checkout around it: it imports xmipp3_tpu_torch
from beside itself (from any working directory), builds every kernel from
the checkout's sources and writes its data under chip_smoke_data/ in the
checkout, which it removes at the end. Without a card, or without the
package beside it, it exits 2 and prints no result. (`chip_smoke.py
--mesh-rank` is a rank of phases 5, 9-13, 15 and 16: it imports torch and
the package, then reads `{"argv": [<program>, <args>], "env": {...},
"log": <file>}` from stdin, runs the program and prints its launch
counts, phase seconds and peak memory. Two such ranks are started ahead
of each mesh run, so that their imports overlap the work before it.)
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N, P, BATCH = 128, 256, 256
VIEWS = 10000  # BASELINE config 3: 10k particles at N=128
DEVICE = "cuda"
TOL = 1e-4         # scatters: float atomics add in a run-dependent order
TOL_CROSS = 1e-5   # cross-spectrum: fixed summation order over the rings
# projection matching at full width: the program's defaults at N=128
MATCH_BATCH, MATCH_SHIFT, GALLERY_RATE = 512, 4, 5.0
RINGS, HARMONICS = 31, 64   # radii 2..62 by 2; rfft bins kept by the scan
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels do plain float32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Gaussian-blob phantom (cz, cy, cx, sigma, amplitude), centred coordinates:
# the phantom of tests/test_project_reconstruct.py with its centres scaled
# from N=48 to N=128 and its widths kept, so that it has power to Nyquist/2.
_SCALE = 128 / 48
BLOBS = [(cz * _SCALE, cy * _SCALE, cx * _SCALE, s, a) for cz, cy, cx, s, a in
         [(0.0, 0.0, 0.0, 3.0, 1.0), (6.0, -4.0, 5.0, 2.0, 0.8),
          (-5.0, 5.0, -3.0, 2.5, 0.6), (3.0, 6.0, -6.0, 1.8, 0.9)]]

# The 8-blob phantom of tests/test_match.py, scaled like BLOBS: its views
# differ enough for projection matching to tell them apart.
BLOBS8 = BLOBS + [(cz * _SCALE, cy * _SCALE, cx * _SCALE, s, a)
                  for cz, cy, cx, s, a in
                  [(-8.0, -7.0, 2.0, 1.5, 1.1), (9.0, 3.0, -2.0, 1.6, 0.7),
                   (-2.0, -9.0, -8.0, 2.2, 0.95), (7.0, 8.0, 7.0, 1.4, 1.2)]]

KERNELS = {  # name -> (CUDA source, the TPU kernel's pallas_call line)
    "scatter_add_3ch": ("xmipp3_tpu_torch/csrc/scatter.cu",
                        "xmipp3_tpu/ops/pallas_scatter.py:132"),
    "tri_scatter": ("xmipp3_tpu_torch/csrc/scatter_tri.cu",
                    "xmipp3_tpu/ops/pallas_scatter_tri.py:234"),
    "kb_scatter_3ch": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                       "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
    "kb_scatter_3ch_slab": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                            "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
    "cross_spectrum": ("xmipp3_tpu_torch/csrc/cross.cu",
                       "xmipp3_tpu/ops/pallas_cross.py:67"),
    "scatter_add_3ch_streams": ("xmipp3_tpu_torch/csrc/scatter.cu",
                                "xmipp3_tpu/ops/pallas_scatter.py:309"),
    "tri_scatter_art_block": ("xmipp3_tpu_torch/csrc/scatter_tri.cu",
                              "xmipp3_tpu/ops/pallas_scatter_tri.py:234"),
    "tri_scatter_sirt_pass": ("xmipp3_tpu_torch/csrc/scatter_tri.cu",
                              "xmipp3_tpu/ops/pallas_scatter_tri.py:234"),
    "kb_scatter_3ch_wbp": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                           "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
    "kb_scatter_3ch_first_split": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                                   "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
    "tri_scatter_first_split3": ("xmipp3_tpu_torch/csrc/scatter_tri.cu",
                                 "xmipp3_tpu/ops/pallas_scatter_tri.py:234"),
    "kb_scatter_3ch_art_zernike3d": (
        "xmipp3_tpu_torch/csrc/scatter_kb.cu",
        "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
    "kb_scatter_3ch_tomogram": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                                "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
}
WIDE_BLOB = ("2.5", "0", "10")   # radius, order, alpha: 160 taps a sample
RUNS = (("kb", (), "kb_scatter_3ch"), ("tri+kb", (), "tri_scatter"),
        ("nn", (), "scatter_add_3ch"),
        ("kb", ("--blob", *WIDE_BLOB), "scatter_add_3ch_streams"))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def max_rel(got, want) -> float:
    """max |got - want| / max |want| in float64 (arrays or tensors)."""
    import torch
    want = torch.as_tensor(want, device=DEVICE).to(torch.float64)
    got = torch.as_tensor(got, device=DEVICE).to(torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def real_corr(a, b) -> float:
    """The real-space correlation of two arrays, in float64."""
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def slice_samples(seed, device):
    """One batch of gridding samples as the main path makes them: slice
    coordinates of random poses (zi, yi, xi) and three value streams."""
    import torch
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.ops.reconstruct import _slice_tap_coords
    rng = np.random.default_rng(seed)
    rot = rng.uniform(0, 360, BATCH)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, BATCH)))
    psi = rng.uniform(0, 360, BATCH)
    mats = torch.as_tensor(euler_matrix(rot, tilt, psi), dtype=torch.float32,
                           device=device)
    coords = [a.reshape(-1).contiguous()
              for a in _slice_tap_coords(mats, N, P, 0.5)]
    M = coords[0].numel()
    vals = np.stack([rng.standard_normal(M), rng.standard_normal(M),
                     rng.uniform(0.5, 1.5, M)]).astype(np.float32)
    vals = [torch.as_tensor(v, device=device) for v in vals]
    return coords, vals


def host_us(fn, reps=200):
    """Host microseconds a call of `fn` takes to return (the wrapper's
    checks and the launch; the card runs behind), then a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / reps * 1e6


def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def cubes(device, size=P ** 3):
    import torch
    return [torch.zeros(size, dtype=torch.float32, device=device)
            for _ in range(3)]


def tap_stats(streams, size):
    """(live taps, touched voxels, touched 32-byte sectors) of the tap
    streams (idx, u0, u1, u2) in `streams`, parts of one launch's updates
    into a cube of `size` voxels (the cubes start on a sector boundary)."""
    import torch
    voxels = torch.zeros(size, dtype=torch.bool, device=DEVICE)
    sectors = torch.zeros(-(-size // 8), dtype=torch.bool, device=DEVICE)
    taps = 0
    for idx, _, _, u2 in streams:
        live = idx[u2 != 0]
        taps += live.numel()
        voxels[live] = True
        sectors[live >> 3] = True
    return taps, int(voxels.sum()), int(sectors.sum())


def compare(name, kernel, plain, stream, bytes_per_sample, ops_per_tap,
            ops_per_sample, M, library=None, size=P ** 3, kernel_reps=20,
            plain_reps=5):
    """Hold `kernel` against `plain` (both fn(c0, c1, c2)) on zeroed cubes
    of `size` voxels, time both, and compute the bound from the plain tap
    stream `stream` (idx, u0, u1, u2) of this run's data, or from the parts
    that the callable `stream` yields where the whole does not fit."""
    import torch
    ck, cp = cubes(DEVICE, size), cubes(DEVICE, size)
    kernel(*ck)
    plain(*cp)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(ck, cp))
    ref = max(float(b.abs().max()) for b in cp)
    rel = err / ref
    log(f"  {name}: max|kernel-plain| = {err:.3e}, / max|plain| = {rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL,
          f"{name}: kernel disagrees with its plain version ({rel:.3e} > "
          f"{TOL})")
    ms = time_ms(lambda: kernel(*ck), reps=kernel_reps)
    call_us = host_us(lambda: kernel(*ck), reps=10 * kernel_reps)
    plain_ms = time_ms(lambda: plain(*cp), reps=plain_reps,
                       warmup=int(plain_reps > 1))
    library_ms = None if library is None else \
        time_ms(lambda: library(*cp), reps=20)
    # bound: the samples read once, every voxel the data touches read and
    # written once in three channels; the taps' float32 arithmetic
    taps, touched, sectors = tap_stats(
        stream() if callable(stream) else [stream], size)
    nbytes = M * bytes_per_sample + touched * 3 * 4 * 2
    # the same counted in the 32-byte sectors an atomic moves in and out of
    # L2
    sector_bytes = M * bytes_per_sample + sectors * 3 * 32 * 2
    sector_bound_ms = sector_bytes / HBM_BYTES_PER_S * 1e3
    atomics_per_s = 3 * taps / (ms * 1e-3)   # a float2 atomic counts as two
    nops = taps * ops_per_tap + M * ops_per_sample
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms"
        + ("" if library_ms is None else f", index_add_ {library_ms:.4f} ms")
        + f"); bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{nops / 1e9:.3f} GFLOP; {taps} live taps, {touched} voxels); "
        f"sector bound {sector_bound_ms:.4f} ms ({sectors} sectors, "
        f"{sector_bytes / 1e6:.1f} MB); {atomics_per_s / 1e9:.1f} G channel "
        f"adds/s; wrapper {call_us:.1f} us a call on the host")
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "samples": M, "live_taps": taps,
            "touched_voxels": touched, "sector_bound_ms": sector_bound_ms,
            "touched_sectors": sectors, "atomics_per_s": atomics_per_s,
            "host_us_per_call": call_us}


def streams_vs_plain(label, idx_streams, v_streams, flat):
    """K5 on stacked streams (ns, M) / (ns, 3, M) against its plain version
    and against index_add_ per stream and channel; `flat` is the same
    updates tap-major (idx, u0, u1, u2), on which K1 is timed in the same
    call: which of the two a footprint of several taps should go through."""
    from xmipp3_tpu_torch.ops import scatter
    name = "scatter_add_3ch_streams"
    log(f"  {name} on {label}: {tuple(idx_streams.shape)}")
    got = compare(
        name,
        lambda *c: scatter.scatter_add_3ch_streams(*c, idx_streams, v_streams),
        lambda *c: scatter.scatter_add_3ch_streams_plain(*c, idx_streams,
                                                         v_streams),
        flat, 16, 3, 0, idx_streams.numel(),
        library=lambda *c: [a.index_add_(0, i, u)
                            for i, v in zip(idx_streams, v_streams)
                            for a, u in zip(c, v)])
    ck = cubes(DEVICE)
    k1_ms = time_ms(lambda: scatter.scatter_add_3ch(*ck, *flat), reps=10)
    got["streams"] = idx_streams.shape[0]
    got["k1_on_flattened_streams_ms"] = k1_ms
    log(f"  scatter_add_3ch on these streams flattened ({flat[0].numel()} "
        f"updates): {k1_ms:.4f} ms, against {got['ms']:.4f} ms for {name} "
        "on them stacked")
    return got


def kernels_vs_plain(seed):
    import torch
    from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri
    from xmipp3_tpu_torch.ops.reconstruct import (BLOB_ALPHA, BLOB_ORDER,
                                                  BLOB_RADIUS, _footprint)
    (zi, yi, xi), (v0, v1, v2) = slice_samples(seed, DEVICE)
    M = zi.numel()
    log(f"phase 2: kernels vs plain at N={N}, P={P}, one {BATCH}-image "
        f"batch: M = {M} samples")
    out = []

    # K1 on the nn update stream of the batch (one tap per sample)
    z0, y0, x0 = (torch.round(a).to(torch.int32) for a in (zi, yi, xi))
    nn = scatter.expand_taps(z0, y0, x0, [(0, 0, 0)],
                             lambda *_: torch.ones_like(zi), v0, v1, v2, P)
    out.append(compare(
        "scatter_add_3ch",
        lambda *c: scatter.scatter_add_3ch(*c, *nn),
        lambda *c: scatter.scatter_add_3ch_plain(*c, *nn),
        nn, 16, 3, 0, nn[0].numel(),
        library=lambda *c: [a.index_add_(0, nn[0], u)
                            for a, u in zip(c, nn[1:])]))
    del nn

    samples = (zi, yi, xi, v0, v1, v2)
    # K2: per sample floor, fractions and 1-f (9); per live corner the
    # weight (2), three products and three adds (6)
    tri = scatter_tri.tri_expand(*samples, P)
    out.append(compare(
        "tri_scatter",
        lambda *c: scatter_tri.tri_scatter(*c, *samples, P=P),
        lambda *c: scatter_tri.tri_scatter_plain(*c, *samples, P=P),
        tri, 24, 8, 9, M,
        library=lambda *c: [a.index_add_(0, tri[0], u)
                            for a, u in zip(c, tri[1:])]))
    del tri

    # K3: per sample floor and fractions (6); per live tap the distance (8),
    # the degree-7 Horner polynomial (14), three products and three adds (6)
    kb = dict(P=P, radius=BLOB_RADIUS, alpha=BLOB_ALPHA, order=BLOB_ORDER)
    kbs = scatter_kb.kb_expand(*samples, **kb)
    out.append(compare(
        "kb_scatter_3ch",
        lambda *c: scatter_kb.kb_scatter_3ch(*c, *samples, **kb),
        lambda *c: scatter_kb.kb_scatter_plain(*c, *samples, **kb),
        kbs, 24, 28, 6, M,
        library=lambda *c: [a.index_add_(0, kbs[0], u)
                            for a, u in zip(c, kbs[1:])]))
    del kbs
    out.append(kb_slab_vs_plain(samples, kb, M))
    torch.cuda.empty_cache()

    # K5 on the 8 trilinear tap streams of the batch (a side reading: K2's
    # taps, as in earlier runs): per update the index and three values (16
    # bytes), three adds
    tri = scatter_tri.tri_expand(*samples, P)
    idx8 = tri[0].view(8, -1)
    v8 = torch.stack([u.view(8, -1) for u in tri[1:]], dim=1).contiguous()
    tri8 = streams_vs_plain("8 trilinear streams", idx8, v8, tri)
    del tri, idx8, v8, samples
    torch.cuda.empty_cache()

    # K5 at the shape the main path gives it: the batch's tap streams under
    # the wide blob, made as backproject_chunk makes them
    radius, order, alpha = WIDE_BLOB
    foot = _footprint(zi, yi, xi, "kb", (float(radius), int(order),
                                         float(alpha)))
    idxw, vw = scatter.expand_tap_streams(*foot, v0, v1, v2, P)
    del foot
    flat = (idxw.view(-1), *(vw[:, k].reshape(-1) for k in range(3)))
    wide = streams_vs_plain(f"{idxw.shape[0]} streams of the blob "
                            + " ".join(WIDE_BLOB), idxw, vw, flat)
    wide["on_8_trilinear_streams"] = {
        k: tri8[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "sector_bound_ms", "rel_err", "max_abs_err",
                             "samples", "live_taps", "atomics_per_s",
                             "k1_on_flattened_streams_ms")}
    out.append(wide)
    del idxw, vw, flat
    torch.cuda.empty_cache()
    out.append(cross_vs_plain(seed))
    torch.cuda.empty_cache()
    return out


SLABS = ((0, P // 2), (P // 2, P // 2))   # (z_lo, zdim): two kz-slabs


def kb_slab_vs_plain(samples, kb, M):
    """K3 in kz-slab mode on the batch: each slab against its plain version
    (as `compare` holds a kernel), then both slabs gridded into views of
    one allocation per channel and held against the full-cube kernel. The
    entry's times and bounds are those of the two launches together, the
    work of the full-cube launch; `slabs` has each launch's."""
    import torch
    from xmipp3_tpu_torch.ops import scatter_kb
    name = "kb_scatter_3ch_slab"
    parts = []
    for z_lo, zdim in SLABS:
        slab = dict(kb, zdim=zdim, z_lo=z_lo)
        log(f"  {name}: planes [{z_lo}, {z_lo + zdim})")
        taps = scatter_kb.kb_expand(*samples, **slab)
        parts.append(compare(
            "kb_scatter_3ch_slab",
            lambda *c: scatter_kb.kb_scatter_3ch(*c, *samples, **slab),
            lambda *c: scatter_kb.kb_scatter_plain(*c, *samples, **slab),
            taps, 24, 28, 6, M, size=zdim * P * P,
            library=lambda *c: [a.index_add_(0, taps[0], u)
                                for a, u in zip(c, taps[1:])]))
        parts[-1].update(z_lo=z_lo, zdim=zdim)
        del taps
    full, stacked = cubes(DEVICE), cubes(DEVICE)
    scatter_kb.kb_scatter_3ch(*full, *samples, **kb)
    for z_lo, zdim in SLABS:
        view = lambda c: c[z_lo * P * P:(z_lo + zdim) * P * P]
        scatter_kb.kb_scatter_3ch(*map(view, stacked), *samples, **kb,
                                  zdim=zdim, z_lo=z_lo)
    torch.cuda.synchronize()
    stack_err = max(max_rel(a, b) for a, b in zip(stacked, full))
    log(f"  {name}: the two slabs stacked against the full-cube kernel: "
        f"max|diff| / max|full| = {stack_err:.3e}")
    check(np.isfinite(stack_err) and stack_err <= TOL, f"{name}: stacked "
          f"slabs disagree with the full cube ({stack_err:.3e} > {TOL})")
    total = lambda k: sum(p[k] for p in parts)
    entry = dict(parts[0])
    entry.update({k: total(k) for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "sector_bound_ms",
        "live_taps", "touched_voxels", "touched_sectors")})
    entry.update(
        max_abs_err=max(p["max_abs_err"] for p in parts),
        rel_err=max(p["rel_err"] for p in parts),
        samples=M, atomics_per_s=3 * entry["live_taps"] / (entry["ms"] * 1e-3),
        host_us_per_call=max(p["host_us_per_call"] for p in parts),
        stacked_vs_full_rel_err=stack_err,
        slabs=[{k: p[k] for k in ("z_lo", "zdim", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "sector_bound_ms",
                                  "live_taps", "max_abs_err", "rel_err")}
               for p in parts])
    entry["bound_by"] = "bytes" if all(p["bound_by"] == "bytes"
                                       for p in parts) else "operations"
    return entry


def cross_operands(seed):
    """K4's operands at the matching run's shapes: ring FFTs of seeded noise
    made as the scan makes them (polar resampling, rfft, 64 harmonics kept)
    for a batch of images and a 5-degree gallery, and the ring weights."""
    import torch
    from xmipp3_tpu_torch.ops.polar import cartesian_to_polar, ring_ffts
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)

    def spectra(count):
        imgs = torch.randn((count, N, N), generator=gen, device=DEVICE)
        pol = cartesian_to_polar(imgs, 2, N // 2 - 2, n_angles=2 * HARMONICS,
                                 stride=2)
        return ring_ffts(pol)[..., :HARMONICS].contiguous()

    R = 1652            # directions of a c1 gallery sampled every 5 degrees
    fi, fr = spectra(MATCH_BATCH), spectra(R)
    check(fi.shape[1:] == (RINGS, HARMONICS), f"ring FFTs {fi.shape}")
    radii = torch.arange(2, 2 + RINGS, dtype=torch.float32, device=DEVICE)
    return fi, fr, radii / radii.sum()


def l2_to_shared_bytes(B, nr, R, K, tile_b, tile_r):
    """What a tiled K4 reads from L2 into shared memory: every image's rings
    once per reference tile, every reference's once per image tile."""
    return 8 * nr * K * (B * -(-R // tile_r) + R * -(-B // tile_b))


def cross_vs_plain(seed):
    """K4 at the matching run's shapes, on cross_operands(seed)."""
    import torch
    from xmipp3_tpu_torch.ops import cross
    name = "cross_spectrum"
    fi, fr, w = cross_operands(seed)
    B, nr, K = fi.shape
    R = fr.shape[0]
    log(f"phase 2: {name} at B={B}, nr={nr}, R={R}, k={K}, with the mirror")
    got = cross.cross_spectrum(fi, fr, w, mirror=True)
    want = cross.cross_spectrum_plain(fi, fr, w, mirror=True)
    torch.cuda.synchronize()
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    rel = err / max(float(p.abs().max()) for p in want)
    log(f"  {name}: max|kernel-plain| = {err:.3e}, / max|plain| = {rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL_CROSS,
          f"{name}: kernel disagrees with its plain version ({rel:.3e} > "
          f"{TOL_CROSS})")
    del got, want
    ms = time_ms(lambda: cross.cross_spectrum(fi, fr, w, mirror=True), reps=20)
    plain_ms = time_ms(lambda: cross.cross_spectrum_plain(fi, fr, w, True),
                       reps=5, warmup=1)

    def library():
        wi = w[None, :, None]
        return (torch.einsum("brk,Rrk->bRk", fi * wi, fr.conj()),
                torch.einsum("brk,Rrk->bRk", fi.conj() * wi, fr.conj()))

    library_ms = time_ms(library, reps=5, warmup=1)
    # what follows K4 in every trial of the scan, per spectrum: the inverse
    # rFFT to the angular curve and the argmax over it
    spec = cross.cross_spectrum(fi, fr, w, mirror=True)[0]
    A = 2 * (K - 1)
    irfft_ms = time_ms(lambda: torch.fft.irfft(spec, n=A), reps=10)
    curve = torch.fft.irfft(spec, n=A)
    argmax_ms = time_ms(lambda: curve.argmax(dim=-1), reps=10)
    del spec, curve
    log(f"  after {name}, per spectrum: irfft(n={A}) {irfft_ms:.4f} ms, "
        f"argmax {argmax_ms:.4f} ms")
    # bound: both operands and the weights read once, the two complex
    # spectra written once; per ring and output pair four multiply-adds
    nbytes = 8 * (B + R) * nr * K + 4 * nr + 2 * 8 * B * R * K
    nops = 8 * B * nr * R * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, two complex einsums "
        f"{library_ms:.4f} ms); bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms)")
    # a model, not a measurement: what the 32 x 32 image x reference block
    # tile of csrc/cross.cu reads from L2 into shared memory
    log(f"  {name}: model of its L2 -> shared reads, 32 x 32 tile: "
        f"{l2_to_shared_bytes(B, nr, R, K, 32, 32) / 1e9:.3f} GB")
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "max_abs_err": err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": [B, nr, R, K],
            "irfft_ms": irfft_ms, "argmax_ms": argmax_ms}


# ---------------------------------------------------------------------------
# phase 3: end to end through the CLI
# ---------------------------------------------------------------------------

def phantom(n, blobs=BLOBS):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for cz, cy, cx, s, a in blobs:
        vol += a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                          / (2 * s ** 2))
    return vol


def projections(n, rot, tilt, psi, sx, sy, blobs=BLOBS, *, device):
    """Exact projections of the phantom at ZYZ poses, each image's content
    moved by (-sx, -sy) so that the metadata shifts (sx, sy) undo it:
    float64 sums on `device` in batches of 1,000 views, float32 images
    (numpy)."""
    import torch
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)       # (V,3,3)
    imgs = np.zeros((len(rot), n, n), np.float32)
    c = torch.arange(n, dtype=torch.float64, device=device) - n // 2
    y, x = c[:, None], c[None, :]
    for lo in range(0, len(rot), 1000):
        sl = slice(lo, lo + 1000)
        acc = torch.zeros((len(rot[sl]), n, n), dtype=torch.float64,
                          device=device)
        for cz, cy, cx, s, a in blobs:
            ctr = np.array([cx, cy, cz])
            px = torch.as_tensor(A[sl, 0] @ ctr - sx[sl], device=device)
            py = torch.as_tensor(A[sl, 1] @ ctr - sy[sl], device=device)
            acc += a * s * np.sqrt(2 * np.pi) * torch.exp(
                -((x - px[:, None, None]) ** 2
                  + (y - py[:, None, None]) ** 2) / (2 * s ** 2))
        imgs[sl] = acc.to(torch.float32).cpu().numpy()
    return imgs


def write_dataset(root: Path, views: int, seed: int, n: int = N,
                  blobs=BLOBS):
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    rng = np.random.default_rng(seed + 1)
    rot = rng.uniform(0, 360, views)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, views)))
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-3, 3, (2, views))
    imgs = projections(n, rot, tilt, psi, sx, sy, blobs, device=DEVICE)
    stk = root / "phantom.mrcs"
    save_image(str(stk), imgs)
    md = MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(rot[i]),
         "angleTilt": float(tilt[i]), "anglePsi": float(psi[i]),
         "shiftX": float(sx[i]), "shiftY": float(sy[i])}
        for i in range(views))
    fn = root / "phantom.xmd"
    md.write(str(fn))
    return fn


def launch_counts(reset=False):
    """Every kernel's launch count since it was last set to 0; reset=True
    sets them all to 0 after reading."""
    from xmipp3_tpu_torch.ops import cross, scatter, scatter_kb, scatter_tri
    where = {"scatter_add_3ch": (scatter, "launches"),
             "tri_scatter": (scatter_tri, "launches"),
             "kb_scatter_3ch": (scatter_kb, "launches"),
             "kb_scatter_3ch_slab": (scatter_kb, "slab_launches"),
             "cross_spectrum": (cross, "launches"),
             "scatter_add_3ch_streams": (scatter, "streams_launches")}
    counts = {k: getattr(m, a) for k, (m, a) in where.items()}
    if reset:
        for m, a in where.values():
            setattr(m, a, 0)
    return counts


def take_phases():
    """The program's span seconds by name since the last take (its device
    seconds and counters left out), and the seconds of the spans opened at
    top level, each of which the run's wall holds once."""
    from xmipp3_tpu_torch.core import timing
    top = timing.top_level_s()
    took = timing.take_timing()
    return {k: v[0] for k, v in took.items()
            if not k.startswith((timing.DEVICE, timing.COUNT))}, top


class Limits:
    """A phase's quality limits: every one is read and reported before the
    phase fails on any (check())."""

    def __init__(self, phase: int):
        self.phase, self.failed = phase, []

    def __call__(self, ok, msg):
        if not ok:
            self.failed.append(msg)

    def check(self):
        check(not self.failed,
              f"phase {self.phase}: " + "; ".join(self.failed))


def run_program(phase: int, report: dict, label, name, args, rc_want=0):
    """Run one program of the port through its CLI entry on the card, with
    every launch count set to 0 just before; fails unless it exits with
    rc_want. report[label] gets its wall, its phases, the untimed rest
    (the wall less the phases opened at top level), the kernels it
    launched and its peak device memory. Returns the program."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.programs import get_program
    torch.cuda.empty_cache()
    launch_counts(reset=True)
    timing.take_timing()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prog = get_program(name)
    t0 = time.perf_counter()
    rc = prog.run_with_args([str(a) for a in args]
                            + ["--device", DEVICE, "-v", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == rc_want, f"phase {phase} {label} ({name}): rc {rc}, "
          f"expected {rc_want}")
    phases, timed = take_phases()
    r = report[label] = {
        "program": name, "wall_s": wall, "phases_s": phases,
        "rest_s": wall - timed,
        "launches": {k: v for k, v in launch_counts().items() if v},
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {label} ({name}): {wall:.3f} s, peak "
        f"{r['peak_device_GB']:.2f} GB, launches {r['launches']}, phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f", rest {r['rest_s']:.3f}")
    return prog


def run_mesh(report: dict, root: Path, label, name, args,
             env_rendezvous=False):
    """Run one program of the port with --mesh dp over 2 gloo ranks on the
    card (run_ranks, in root/mesh_<label>); report[label] gets the wall
    and each rank's report. Returns the ranks' reports."""
    work = root / f"mesh_{label}"
    work.mkdir()
    wall, reps = run_ranks(name, [str(a) for a in args] + ["--mesh", "dp"],
                           2, work, env_rendezvous)
    report[label] = {"program": name, "ranks": 2, "wall_s": wall,
                     "per_rank": reps}
    log(f"  {label} ({name} --mesh dp, 2 ranks): {wall:.3f} s; " + "; ".join(
        f"rank {r} {rep['wall_s']:.3f} s, launches "
        f"{ {k: v for k, v in rep['launches'].items() if v} }"
        for r, rep in enumerate(reps)))
    return reps


def md_rows(fn):
    """The rows of a metadata file, in order."""
    from xmipp3_tpu_torch.core.metadata import MetaData
    md = MetaData(str(fn))
    return [md.getRow(i) for i in md]


def map_quality(path, ref):
    """(map, FSC curve against ref, real-space correlation with ref)."""
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.ops.fsc import fsc_3d
    rec = np.squeeze(Image(str(path)).data)
    check(rec.shape == ref.shape and np.isfinite(rec).all(),
          f"{path.name}: map of shape {rec.shape}, finite "
          f"{np.isfinite(rec).all()}")
    _, fsc = fsc_3d(rec, ref, device=DEVICE)
    return rec, fsc.cpu().numpy(), real_corr(rec, ref)


def end_to_end(seed, root: Path):
    """Phase 3 in root (kept for phase 5); returns the launches and the
    dataset and serial kb volume phase 5 reads."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.programs import main as xmipp
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    md = write_dataset(root, VIEWS, seed)
    log(f"phase 3: {VIEWS} phantom views at N={N} written in "
        f"{time.perf_counter() - t0:.2f} s")
    ref = phantom(N)
    launches, runs = {}, []
    timing.enable_timing(True)
    try:
        for interp, extra, kname in RUNS:
            label = " ".join((interp, *extra))
            out = root / f"rec_{len(runs)}.vol"
            launch_counts(reset=True)
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", "reconstruct_fourier", "-i", str(md), "-o",
                        str(out), "--interp", interp, *extra, "--device",
                        DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            phases, _ = take_phases()
            check(rc == 0, f"reconstruct_fourier --interp {label}: rc {rc}")
            launches[kname] = counts[kname]
            check(counts[kname] > 0, f"--interp {label} never launched "
                  f"{kname}: {counts}")
            _, fsc, corr = map_quality(out, ref)
            half = fsc[: len(fsc) // 2]
            run = {"interp": label, "kernel": kname, "launches": counts,
                   "wall_s": wall, "images_per_s": VIEWS / wall,
                   "fsc_min_to_half_nyquist": float(half.min()),
                   "corr": corr,
                   "phases_s": phases}
            log(f"  --interp {label}: {wall:.3f} s, {VIEWS / wall:.1f} "
                f"images/s, launches {counts}, min FSC to Nyquist/2 "
                f"{half.min():.4f}, corr {corr:.4f}, phases "
                + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))
            if interp == "nn" or extra:
                check(corr >= 0.9, f"--interp {label}: correlation "
                      f"{corr:.4f} with the phantom < 0.9")
            else:
                check(half.min() >= 0.9, f"--interp {interp}: FSC "
                      f"{half.min():.4f} < 0.9 below half Nyquist")
            runs.append(run)
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    log("e2e " + json.dumps({"runs": runs}))
    return launches, md, root / "rec_0.vol"


# ---------------------------------------------------------------------------
# phase 4: gallery -> projection matching -> reconstruction, through the CLI
# ---------------------------------------------------------------------------

def effective_directions(rows):
    """Unit view directions of assignment rows: the matched reference's
    direction, negated where the match is flipped (proj(-d) is the mirror
    of proj(d), so both name the same view)."""
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    col = lambda k: np.array([float(r[k]) for r in rows])
    d = directions_from_angles(np.stack([col("angleRot"), col("angleTilt")],
                                        1))
    return np.where((col("flip") > 0)[:, None], -d, d)


def cycle_poses(seed):
    """Phase 4's true poses (VIEWS uniform directions, psi uniform, shifts
    in +-3 px; numpy's draws from the seed) and the Generator, which goes
    on to draw the views' noise."""
    rng = np.random.default_rng(seed + 3)
    rot = rng.uniform(0, 360, VIEWS)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, VIEWS)))
    psi = rng.uniform(0, 360, VIEWS)
    sx, sy = rng.uniform(-3, 3, (2, VIEWS))
    return dict(rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy), rng


def matching_cycle(seed, root: Path):
    """Phase 4 in root (kept for phase 5); returns the launches and the
    matching run's arguments."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    from xmipp3_tpu_torch.ops.match import _trial_shift_grid
    from xmipp3_tpu_torch.programs import main as xmipp
    root.mkdir(parents=True)
    ref = phantom(N, BLOBS8)
    save_image(str(root / "phantom.vol"), ref)
    p, rng = cycle_poses(seed)
    rot, tilt, psi, sx, sy = (p[k] for k in ("rot", "tilt", "psi", "sx",
                                             "sy"))
    t0 = time.perf_counter()
    clean = projections(N, rot, tilt, psi, sx, sy, BLOBS8, device=DEVICE)
    stk = root / "views.mrcs"
    save_image(str(stk), clean + (0.5 * clean.std()) * rng.standard_normal(
        clean.shape, dtype=np.float32))
    MetaData.fromRows({"image": f"{i + 1}@{stk}", "itemId": i + 1}
                      for i in range(VIEWS)).write(str(root / "views.xmd"))
    log(f"phase 4: {VIEWS} noisy views of the 8-blob phantom at N={N} "
        f"written in {time.perf_counter() - t0:.2f} s")

    steps = (
        ("angular_project_library",
         ["-i", str(root / "phantom.vol"), "-o", str(root / "gallery"),
          "--sampling_rate", str(GALLERY_RATE)]),
        ("angular_projection_matching",
         ["-i", str(root / "views.xmd"), "-o", str(root / "assigned.xmd"),
          "--ref", str(root / "gallery"), "--max_shift", str(MATCH_SHIFT),
          "--batch", str(MATCH_BATCH)]),
        ("reconstruct_fourier",
         ["-i", str(root / "assigned.xmd"), "-o", str(root / "cycle.vol")]))
    report, launches = {}, {}
    timing.enable_timing(True)
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, args in steps:
            launch_counts(reset=True)
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", name, *args, "--device", DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"{name}: rc {rc}")
            report[name] = {
                "wall_s": wall, "launches": launch_counts(),
                "phases_s": take_phases()[0],
                "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
            torch.cuda.reset_peak_memory_stats()
            log(f"  {name}: {wall:.3f} s")

        gallery = MetaData(str(root / "gallery.doc"))
        n_refs = gallery.size()
        trials = len(_trial_shift_grid(MATCH_SHIFT))
        batches = -(-VIEWS // MATCH_BATCH)
        launches = report["angular_projection_matching"]["launches"]
        k4 = launches["cross_spectrum"]
        log(f"  gallery: {n_refs} directions; cross_spectrum launched {k4} "
            f"times ({trials} trial shifts x {batches} batches = "
            f"{trials * batches} expected)")
        check(k4 > 0, "the matching run never launched cross_spectrum")
        check(k4 == trials * batches, f"cross_spectrum launched {k4} times, "
              f"expected {trials * batches}")

        md = MetaData(str(root / "assigned.xmd"))
        rows = [md.getRow(i) for i in md]
        check(len(rows) == VIEWS, f"{len(rows)} assignments for {VIEWS} views")
        col = lambda k: np.array([float(r[k]) for r in rows])
        order = col("itemId").astype(int) - 1
        flip = col("flip") > 0
        d_true = directions_from_angles(np.stack([rot, tilt], 1))[order]
        d_got = effective_directions(rows)
        ang = np.degrees(np.arccos(np.clip((d_true * d_got).sum(1), -1, 1)))
        within = float((ang <= 1.5 * GALLERY_RATE).mean())
        shift_err = np.hypot(col("shiftX") - sx[order],
                             col("shiftY") - sy[order])
        _, fsc, corr = map_quality(root / "cycle.vol", ref)
        res = fsc_program(root / "cycle.vol", root / "phantom.vol", 1.0,
                          root / "cycle_vs_phantom.frc")
        report["quality"] = {
            "gallery_directions": n_refs,
            "within_7.5_deg": within, "median_angle_deg": float(np.median(ang)),
            "median_shift_err_px": float(np.median(shift_err)),
            "flipped": float(flip.mean()),
            "mean_maxCC": float(col("maxCC").mean()), "map_corr": corr,
            "fsc": [round(float(v), 4) for v in fsc],
            "resolution_fsc_0.143_px": res}
        log(f"  {within:.4f} of the views within {1.5 * GALLERY_RATE} deg of "
            f"their direction (median {np.median(ang):.2f} deg), median shift "
            f"error {np.median(shift_err):.3f} px, map correlation "
            f"{corr:.4f}; resolution_fsc against the phantom: {res:.3f} px "
            "(0.143)")
        check(within >= 0.9, f"only {within:.4f} of the views were assigned "
              f"within {1.5 * GALLERY_RATE} deg of their direction")
        check(np.median(shift_err) <= 0.5, "median shift error "
              f"{np.median(shift_err):.3f} px > 0.5")
        check(corr >= 0.8, f"the cycle's map correlates {corr:.4f} < 0.8 "
              "with the phantom")
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    log("cycle " + json.dumps(report))
    poses = dict(rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy)
    return launches, steps[1][1], clean, poses


def fsc_program(vol, ref, sampling, out: Path) -> float:
    """The port's resolution_fsc -i vol --ref ref -s sampling -o out on the
    card; returns its 0.143 resolution (in the unit of `sampling`)."""
    from xmipp3_tpu_torch.programs import get_program
    prog = get_program("resolution_fsc")
    rc = prog.run_with_args(["-i", str(vol), "--ref", str(ref), "-s",
                             str(sampling), "-o", str(out), "--device",
                             DEVICE, "-v", "0"])
    check(rc == 0 and out.is_file(), f"resolution_fsc {vol.name}: rc {rc}")
    check(np.isfinite(prog.resolution) and prog.resolution > 0,
          f"resolution_fsc {vol.name}: resolution {prog.resolution}")
    return float(prog.resolution)


# ---------------------------------------------------------------------------
# phase 5: the mesh paths through the CLI, ranks on the one card
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 300   # a whole run of the ranks, start to exit
MESH_RUNS = (  # (program, mode, ranks)
    ("reconstruct_fourier", "slab", 2), ("reconstruct_fourier", "slab2d", 4),
    ("reconstruct_fourier", "dp", 2),
    ("angular_projection_matching", "dp", 2),
    ("angular_projection_matching", "tp", 2))


def mesh_rank() -> int:
    """One rank of the mesh runs: import torch and the package, wait for
    the command line on stdin ({argv, env, log}; none: exit 0), send
    stdout and stderr to the log, run the program of argv with every
    launch count at 0 and phase timing on, then print a line RANK {rc,
    wall_s, launches, phases_s, peak_device_GB} with the program's local
    shift field (`field`) where it keeps one."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.programs import get_program
    line = sys.stdin.readline()
    if not line:
        return 0
    cmd = json.loads(line)
    argv = cmd["argv"]
    os.environ.update(cmd["env"])
    fd = os.open(cmd["log"], os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    timing.enable_timing(True)
    launch_counts(reset=True)
    t0 = time.perf_counter()
    program = get_program(argv[0])
    program.read(["xmipp_" + argv[0], *argv[1:]])
    rc = program.tryRun()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = {"rc": rc, "wall_s": wall, "launches": launch_counts(),
           "phases_s": take_phases()[0],
           "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    if getattr(program, "field", None) is not None:
        rep["field"] = np.asarray(program.field).tolist()
    print("RANK " + json.dumps(rep), flush=True)
    return rc


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


WARM_RANKS = []   # two ranks of the next 2-rank mesh run, started ahead


def rank_process(n: int):
    """A mesh_rank process of a run of n ranks (its host threads shared
    out among them, as torchrun does), waiting for its command."""
    env = {**os.environ, "OMP_NUM_THREADS": str(max(1, os.cpu_count() // n))}
    return subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank"],
        stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, cwd=ROOT, env=env, text=True)


def stop_warm_ranks():
    """End the ranks started ahead: at the end of their input they exit."""
    for p in WARM_RANKS:
        p.stdin.close()
    for p in WARM_RANKS:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    WARM_RANKS.clear()


atexit.register(stop_warm_ranks)


def warm_ranks():
    """Start the next 2-rank mesh run's ranks now."""
    while len(WARM_RANKS) < 2:
        WARM_RANKS.append(rank_process(2))


def run_ranks(program, args, n, logs: Path, env_rendezvous=False):
    """Run n ranks of `program args` in a gloo group on cuda:0 (a 2-rank
    run takes the ranks started ahead, and starts the next run's), wait
    at most RANK_TIMEOUT_S for all, stop every one that is left, and
    return (wall seconds, each rank's RANK report); fails on any rank's
    failure. The ranks meet through --dist_coordinator/--dist_nprocs/
    --dist_procid, or with env_rendezvous (a program without those flags)
    through torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK)."""
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            if env_rendezvous:
                env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(n), RANK=str(r))
                flags = []
            else:
                env = {}
                flags = ["--dist_coordinator", f"127.0.0.1:{port}",
                         "--dist_nprocs", str(n), "--dist_procid", str(r)]
            p = WARM_RANKS.pop() if n == 2 and WARM_RANKS else \
                rank_process(n)
            procs.append(p)
            try:
                p.stdin.write(json.dumps({
                    "argv": [program, *args, *flags, "--device", DEVICE,
                             "-v", "1"], "env": env,
                    "log": str(logs / f"rank{r}.log")}) + "\n")
                p.stdin.close()
            except BrokenPipeError:
                pass   # it died on its imports: its exit code fails below
        warm_ranks()
        for p in procs:
            left = RANK_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{program}: the ranks did not finish "
                                   f"within {RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    reports = []
    for r, p in enumerate(procs):
        log_file = logs / f"rank{r}.log"
        text = log_file.read_text() if log_file.is_file() else ""
        check(p.returncode == 0, f"{program} rank {r} of {n} exited with "
              f"{p.returncode}:\n{text[-3000:]}")
        line = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        check(line, f"{program} rank {r}: no report\n{text[-3000:]}")
        reports.append(json.loads(line[-1][5:]))
        mesh_line = [ln for ln in text.splitlines() if ln.startswith("mesh:")]
        if r == 0 and mesh_line:
            log(f"  {mesh_line[0]}")
    return wall, reports


def mesh_runs(root: Path, rec_md: Path, serial_vol: Path, match_args):
    """Phase 5; returns the launches of K3's slab mode over every rank."""
    import torch
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.core.metadata import MetaData
    torch.cuda.empty_cache()
    serial = np.squeeze(Image(str(serial_vol)).data)
    ref = phantom(N)
    md = MetaData(str(match_args[match_args.index("-o") + 1]))
    serial_rows = {int(r["itemId"]): r for r in (md.getRow(i) for i in md)}
    slab_launches, runs = 0, []
    for program, mode, n in MESH_RUNS:
        label = f"{program} --mesh {mode} over {n} ranks"
        work = root / f"mesh_{program}_{mode}"
        work.mkdir()
        out = work / ("rec.vol" if program == "reconstruct_fourier"
                      else "assigned.xmd")
        if program == "reconstruct_fourier":
            args = ["-i", str(rec_md), "-o", str(out), "--interp", "kb"]
        else:
            args = list(match_args)
            args[args.index("-o") + 1] = str(out)
        wall, reps = run_ranks(program, args + ["--mesh", mode], n, work)
        run = {"program": program, "mode": mode, "ranks": n, "wall_s": wall,
               "per_rank": reps}
        if program == "reconstruct_fourier":
            kname = "kb_scatter_3ch" if mode == "dp" else \
                "kb_scatter_3ch_slab"
            for r, rep in enumerate(reps):
                check(rep["launches"][kname] > 0, f"{label}: rank {r} never "
                      f"launched {kname}: {rep['launches']}")
            if mode != "dp":
                slab_launches += sum(rep["launches"][kname] for rep in reps)
            vol, fsc, corr = map_quality(out, ref)
            err = max_rel(vol, serial)
            half = fsc[: len(fsc) // 2]
            run.update(rel_err_vs_serial=err,
                       fsc_min_to_half_nyquist=float(half.min()), corr=corr)
            result = (f"max|mesh - serial| / max|serial| = {err:.3e}, min FSC "
                      f"to Nyquist/2 {half.min():.4f}")
            check(err <= TOL, f"{label}: the volume differs from the serial "
                  f"one by {err:.3e} > {TOL}")
            check(half.min() >= 0.9, f"{label}: FSC {half.min():.4f} < 0.9 "
                  "below half Nyquist")
        else:
            for r, rep in enumerate(reps):
                check(rep["launches"]["cross_spectrum"] > 0, f"{label}: rank "
                      f"{r} never launched cross_spectrum")
            md = MetaData(str(out))
            rows = [md.getRow(i) for i in md]
            check(len(rows) == len(serial_rows), f"{label}: {len(rows)} rows")
            base = [serial_rows[int(r["itemId"])] for r in rows]
            # the same view: within 0.1 deg (the angles are float32, gallery
            # neighbours lie degrees apart), the exact antipode with the
            # other flip counted in (effective_directions)
            cos = (effective_directions(rows)
                   * effective_directions(base)).sum(1)
            ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
            same = float((ang <= 0.1).mean())
            run["same_direction_as_serial"] = same
            result = f"{same:.4f} of the views in the serial run's direction"
            check(same >= 0.99, f"{label}: only {same:.4f} of the views keep "
                  "the serial run's direction")
        log(f"  {label}: {wall:.3f} s, {result}; " + "; ".join(
            f"rank {r} {rep['wall_s']:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in rep["phases_s"].items())
            + ")" for r, rep in enumerate(reps)))
        runs.append(run)
    log("mesh " + json.dumps({"runs": runs}))
    return slab_launches


# ---------------------------------------------------------------------------
# phase 6: the CTF-corrected cycle through the CLI
# ---------------------------------------------------------------------------

CTF_TS = 2.0                     # A/px
CTF_GROUPS = 20                  # micrographs of VIEWS / CTF_GROUPS views
CTF_KV, CTF_CS, CTF_Q0 = 300.0, 2.7, 0.1
WIENER_VIEWS = 512
CTF_TOL = 1e-4                   # port (float32) against numpy (float64)
# --minCTF of every --useCTF reconstruction: at the default 0.01, 1/c
# amplifies the noise near the CTF zeros, and the reference package's map
# of phase 6's views at the port's assigned poses correlates 0.794 with the
# phantom; at 0.05 / 0.1 it reaches 0.897 / 0.915
# (tools/plan_ctf_cycle.py --min-ctf). At 0.1 phase 4's limit holds.
CTF_MIN = 0.1
CYCLE_CTF_MAP_CORR = 0.8


def ctf_recipe(groups: int = CTF_GROUPS):
    """(defocusU, defocusV, azimuth in degrees) of each micrograph:
    defocusU evenly over 8,000-20,000 A, 300 A of astigmatism, azimuths
    evenly over [0, 180)."""
    dfu = np.linspace(8000.0, 20000.0, groups)
    return dfu, dfu + 300.0, 180.0 * np.arange(groups) / groups


def plant_ctf(n: int, Ts: float, dfu: float, dfv: float, az_deg: float,
              kv: float = CTF_KV, cs: float = CTF_CS, q0: float = CTF_Q0):
    """The CTF of one micrograph in the rfft2 layout of an n x n image, in
    float64 numpy, written out here rather than taken from the port, so
    that a sign or a unit wrong in the port cannot cancel itself: chi =
    pi lambda df(theta) u^2 + pi/2 Cs lambda^3 u^4, with
    df(theta) = -(dfU + dfV)/2 - (dfU - dfV)/2 cos 2(theta - azimuth);
    CTF = -(sqrt(1 - Q0^2) sin chi - Q0 cos chi). The self-conjugate
    columns (fx = 0 and Nyquist) are averaged over +-fy, so that the
    filter keeps real images real."""
    fy = np.fft.fftfreq(n)[:, None] / Ts
    fx = np.fft.rfftfreq(n)[None, :] / Ts
    u2 = fx * fx + fy * fy
    v = kv * 1e3
    lam = 12.2643247 / np.sqrt(v * (1 + 0.978466e-6 * v))
    df = -(dfu + dfv) / 2 - (dfu - dfv) / 2 * np.cos(
        2 * (np.arctan2(fy, fx) - np.deg2rad(az_deg)))
    chi = np.pi * lam * df * u2 + np.pi / 2 * cs * 1e7 * lam ** 3 * u2 ** 2
    c = -(np.sqrt(1 - q0 ** 2) * np.sin(chi) - q0 * np.cos(chi))
    for col in (0, -1):
        c[:, col] = 0.5 * (c[:, col] + np.roll(c[::-1, col], 1))
    return c


def ctf_stack(clean, groups: int = CTF_GROUPS, Ts: float = CTF_TS):
    """The views with micrograph g's CTF applied to views
    [g * per, (g + 1) * per), float32."""
    n = clean.shape[-1]
    per = -(-len(clean) // groups)
    out = np.empty_like(clean)
    for g, (u, v, az) in enumerate(zip(*ctf_recipe(groups))):
        sl = slice(g * per, (g + 1) * per)
        out[sl] = np.fft.irfft2(np.fft.rfft2(clean[sl])
                                * plant_ctf(n, Ts, u, v, az), s=(n, n))
    return out


def ctf_cycle(seed, root: Path, clean, poses, cycle: Path):
    """Phase 6 in root, on phase 4's clean views (clean) and poses, with
    phase 4's gallery and phantom (in cycle); returns the launches of the
    phase's runs."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    from xmipp3_tpu_torch.ops.ctf import (CTFDescription, ctf_params_arrays,
                                          generate_2d_rows, phase_flip)
    from xmipp3_tpu_torch.ops.reconstruct import ctf_gridding_multipliers
    from xmipp3_tpu_torch.programs import main as xmipp
    root.mkdir(parents=True)
    descs = [CTFDescription(sampling_rate=CTF_TS, voltage=CTF_KV,
                            defocusU=float(u), defocusV=float(v),
                            azimuthal_angle=float(az), Cs=CTF_CS, Q0=CTF_Q0)
             for u, v, az in zip(*ctf_recipe())]
    worst = 0.0
    for d, (u, v, az) in zip(descs, zip(*ctf_recipe())):
        want = plant_ctf(N, CTF_TS, u, v, az)
        got = d.generate_2d(N, N, damped=False, device=DEVICE).cpu().numpy()
        worst = max(worst, max_rel(got, want))
    log(f"phase 6: the port's CTF against the planted one: max |port - "
        f"numpy| / max = {worst:.3e} over {CTF_GROUPS} micrographs")
    # float32 chi reaches ~78 rad at Nyquist (20,000 A at 2 A/px): its
    # roundoff, a few 1e-6 rad an operation, leaves ~2e-5 of the max
    check(worst <= CTF_TOL, f"the port's generate_2d differs from the "
          f"planted CTF by {worst:.3e} > {CTF_TOL} of its max")

    t0 = time.perf_counter()
    per = VIEWS // CTF_GROUPS
    models = []
    for g, d in enumerate(descs):
        models.append(str(root / f"mic{g:02d}.ctfparam"))
        d.write(models[-1])
    ctf_clean = ctf_stack(clean)
    rng = np.random.default_rng(seed + 5)
    ctf_noisy = ctf_clean + (0.5 * ctf_clean.std()) * rng.standard_normal(
        ctf_clean.shape, dtype=np.float32)
    save_image(str(root / "ctf_clean.mrcs"), ctf_clean)
    save_image(str(root / "ctf_noisy.mrcs"), ctf_noisy)
    del ctf_clean
    pose = lambda i: {"angleRot": float(poses["rot"][i]),
                      "angleTilt": float(poses["tilt"][i]),
                      "anglePsi": float(poses["psi"][i]),
                      "shiftX": float(poses["sx"][i]),
                      "shiftY": float(poses["sy"][i])}
    MetaData.fromRows(
        {"image": f"{i + 1}@{root / 'ctf_clean.mrcs'}", **pose(i),
         "ctfModel": models[i // per]} for i in range(VIEWS)).write(
        str(root / "true_model.xmd"))
    inline = lambda d: {"ctfSamplingRate": d.sampling_rate,
                        "ctfVoltage": d.voltage, "ctfDefocusU": d.defocusU,
                        "ctfDefocusV": d.defocusV,
                        "ctfDefocusAngle": d.azimuthal_angle,
                        "ctfSphericalAberration": d.Cs, "ctfQ0": d.Q0}
    rows = [{"image": f"{i + 1}@{root / 'ctf_noisy.mrcs'}", "itemId": i + 1,
             **inline(descs[i // per])} for i in range(VIEWS)]
    MetaData.fromRows(rows).write(str(root / "noisy.xmd"))
    # the phase-flipped views (named as ctf_phase_flip writes them) at their
    # true poses: the map the cycle would close on with perfect matching
    MetaData.fromRows(
        {**r, "image": f"{i + 1:06d}@{root / 'flipped.mrcs'}", **pose(i)}
        for i, r in enumerate(rows)).write(str(root / "flipped_true.xmd"))
    MetaData.fromRows(rows[:WIENER_VIEWS]).write(str(root / "wiener_in.xmd"))
    log(f"  {VIEWS} views in {CTF_GROUPS} micrographs of {per} (defocusU "
        f"8,000-20,000 A at {CTF_TS} A/px), CTF planted with numpy, noise of "
        f"0.5 sigma after it, written in {time.perf_counter() - t0:.2f} s")

    ref = phantom(N, BLOBS8)
    mid = models[CTF_GROUPS // 2]
    steps = (
        ("true poses --useCTF", "reconstruct_fourier",
         ["-i", str(root / "true_model.xmd"), "-o", str(root / "true.vol"),
          "--useCTF", "--sampling", str(CTF_TS), "--minCTF", str(CTF_MIN)]),
        ("true poses, no --useCTF", "reconstruct_fourier",
         ["-i", str(root / "true_model.xmd"), "-o",
          str(root / "true_noctf.vol")]),
        ("phase flip", "ctf_phase_flip",
         ["-i", str(root / "noisy.xmd"), "-o", str(root / "flipped.mrcs"),
          "--save_metadata_stack", str(root / "flipped.xmd")]),
        ("flipped views, true poses", "reconstruct_fourier",
         ["-i", str(root / "flipped_true.xmd"), "-o",
          str(root / "flipped_true.vol"), "--useCTF", "--phaseFlipped",
          "--sampling", str(CTF_TS), "--minCTF", str(CTF_MIN)]),
        ("matching", "angular_projection_matching",
         ["-i", str(root / "flipped.xmd"), "-o", str(root / "assigned.xmd"),
          "--ref", str(cycle / "gallery"), "--max_shift", str(MATCH_SHIFT),
          "--batch", str(MATCH_BATCH), "--phase_flipped", "--ctf", mid]),
        ("cycle reconstruction", "reconstruct_fourier",
         ["-i", str(root / "assigned.xmd"), "-o", str(root / "cycle.vol"),
          "--useCTF", "--phaseFlipped", "--sampling", str(CTF_TS),
          "--minCTF", str(CTF_MIN), "--prepare_fsc", str(root / "half")]),
        ("halves", "resolution_fsc",
         ["-i", str(root / "half_2_recons.vol"), "--ref",
          str(root / "half_1_recons.vol"), "-s", str(CTF_TS), "-o",
          str(root / "halves.frc")]),
        ("Wiener", "ctf_correct_wiener2d",
         ["-i", str(root / "wiener_in.xmd"), "-o", str(root / "wiener.mrcs"),
          "--pad", "2"]))
    report, launches = {}, {}
    limit = Limits(6)

    timing.enable_timing(True)
    torch.cuda.reset_peak_memory_stats()
    try:
        for label, name, args in steps:
            launch_counts(reset=True)
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", name, *args, "--device", DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"phase 6 {label} ({name}): rc {rc}")
            phases, timed = take_phases()
            report[label] = {
                "program": name, "wall_s": wall,
                "launches": {k: v for k, v in launch_counts().items() if v},
                "phases_s": phases, "rest_s": wall - timed,
                "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
            torch.cuda.reset_peak_memory_stats()
            log(f"  {label} ({name}): {wall:.3f} s, launches "
                f"{report[label]['launches']}, phases "
                + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        batches = -(-VIEWS // BATCH)
        for label in ("true poses --useCTF", "true poses, no --useCTF",
                      "flipped views, true poses", "cycle reconstruction"):
            k3 = report[label]["launches"].get("kb_scatter_3ch", 0)
            check(k3 == batches, f"phase 6 {label}: kb_scatter_3ch launched "
                  f"{k3} times, expected {batches}")
        k4 = report["matching"]["launches"].get("cross_spectrum", 0)
        check(k4 == 13 * -(-VIEWS // MATCH_BATCH), f"phase 6 matching: "
              f"cross_spectrum launched {k4} times, expected "
              f"{13 * -(-VIEWS // MATCH_BATCH)}")
        launches = {"kb_scatter_3ch": sum(
            report[k]["launches"].get("kb_scatter_3ch", 0) for k in report),
            "cross_spectrum": k4}

        # (a) the correction undoes the planted CTF
        quality = {}
        for key, label in (("usectf", "true poses --useCTF"),
                           ("no_usectf", "true poses, no --useCTF")):
            vol = root / ("true.vol" if key == "usectf" else "true_noctf.vol")
            _, fsc, corr = map_quality(vol, ref)
            half = fsc[: len(fsc) // 2]
            quality[f"true_{key}"] = {"fsc_min_to_half_nyquist":
                                      float(half.min()), "corr": corr}
        a, b = quality["true_usectf"], quality["true_no_usectf"]
        fa, fb = a["fsc_min_to_half_nyquist"], b["fsc_min_to_half_nyquist"]
        log(f"  true poses: min FSC to Nyquist/2 {fa:.4f} with --useCTF, "
            f"{fb:.4f} without; corr {a['corr']:.4f} / {b['corr']:.4f}")
        limit(fa >= 0.9, f"--useCTF from true poses: FSC {fa:.4f} < 0.9 "
              "below half Nyquist")
        limit(fa > fb and a["corr"] > b["corr"], "--useCTF did not improve "
              "on the uncorrected reconstruction")

        # (b) the phase-flipped cycle
        md = MetaData(str(root / "assigned.xmd"))
        rows = [md.getRow(i) for i in md]
        check(len(rows) == VIEWS, f"phase 6: {len(rows)} assignments")
        col = lambda k: np.array([float(r[k]) for r in rows])
        order = col("itemId").astype(int) - 1
        d_true = directions_from_angles(np.stack(
            [poses["rot"], poses["tilt"]], 1))[order]
        ang = np.degrees(np.arccos(np.clip(
            (d_true * effective_directions(rows)).sum(1), -1, 1)))
        within = float((ang <= 1.5 * GALLERY_RATE).mean())
        shift_err = float(np.median(np.hypot(col("shiftX") - poses["sx"][order],
                                             col("shiftY") - poses["sy"][order])))
        _, fsc, corr = map_quality(root / "cycle.vol", ref)
        _, _, corr_true = map_quality(root / "flipped_true.vol", ref)
        res_vs_phantom = fsc_program(root / "cycle.vol", cycle / "phantom.vol",
                                     CTF_TS, root / "vs_phantom.frc")
        halves = MetaData(str(root / "halves.frc"))
        frc = halves.getColumn("resolutionFRC").astype(float)
        freq = halves.getColumn("resolutionFreq").astype(float)
        below = np.nonzero(frc < 0.143)[0]
        res_halves = float(1 / freq[below[0]]) if len(below) else \
            2 * CTF_TS
        quality["cycle"] = {
            "within_7.5_deg": within,
            "median_angle_deg": float(np.median(ang)),
            "median_shift_err_px": shift_err, "map_corr": corr,
            "map_corr_flipped_views_true_poses": corr_true,
            "fsc_min_to_half_nyquist": float(fsc[: len(fsc) // 2].min()),
            "resolution_vs_phantom_A": res_vs_phantom,
            "halves_first_shell_below_0.143_A": res_halves}
        log(f"  cycle: {within:.4f} of the views within {1.5 * GALLERY_RATE} "
            f"deg (median {np.median(ang):.2f} deg), median shift error "
            f"{shift_err:.3f} px, map correlation {corr:.4f} (the same "
            f"views at their true poses {corr_true:.4f}); resolution_fsc "
            f"against the phantom {res_vs_phantom:.3f} A, halves' FRC first "
            f"below 0.143 at {res_halves:.3f} A")
        limit(within >= 0.9, f"phase 6: only {within:.4f} of the views within "
              f"{1.5 * GALLERY_RATE} deg")
        limit(shift_err <= 0.5, f"phase 6: median shift error "
              f"{shift_err:.3f} px > 0.5")
        limit(corr >= CYCLE_CTF_MAP_CORR, f"phase 6: the cycle's map "
              f"correlates {corr:.4f} < {CYCLE_CTF_MAP_CORR} with the "
              "phantom")

        # (c) Wiener: closer to the clean projections than the raw views
        wien = np.squeeze(Image(str(root / "wiener.mrcs")).data)
        check(wien.shape == (WIENER_VIEWS, N, N) and np.isfinite(wien).all(),
              f"phase 6 Wiener: output of shape {wien.shape}")

        def mean_corr(a, b):
            a = a.reshape(len(a), -1) - a.reshape(len(a), -1).mean(1)[:, None]
            b = b.reshape(len(b), -1) - b.reshape(len(b), -1).mean(1)[:, None]
            return float(((a * b).sum(1) / np.sqrt((a * a).sum(1)
                                                   * (b * b).sum(1))).mean())
        quality["wiener"] = {
            "corr_raw": mean_corr(ctf_noisy[:WIENER_VIEWS],
                                  clean[:WIENER_VIEWS]),
            "corr_corrected": mean_corr(wien, clean[:WIENER_VIEWS])}
        w = quality["wiener"]
        log(f"  Wiener ({WIENER_VIEWS} views): mean correlation with the clean "
            f"views {w['corr_corrected']:.4f} corrected, {w['corr_raw']:.4f} "
            "raw")
        limit(w["corr_corrected"] > w["corr_raw"], "phase 6: the Wiener-"
              "corrected views are no closer to the clean ones than the raw")

        # what the CTF work costs on the card
        p_batch = ctf_params_arrays(descs[:1] * BATCH)
        table_ms = time_ms(lambda: ctf_gridding_multipliers(
            p_batch, CTF_TS, CTF_MIN, N, 0.5, False, device=DEVICE), 20)
        flip_descs = [descs[i // per] for i in range(MATCH_BATCH)]
        rows_ms = time_ms(lambda: generate_2d_rows(
            flip_descs, N, N, damped=False, device=DEVICE), 20)
        batch = torch.as_tensor(ctf_noisy[:MATCH_BATCH], device=DEVICE)
        flip_ms = time_ms(lambda: phase_flip(batch, flip_descs), 20)
        quality["card_ms"] = {
            f"ctf_table_{BATCH}_rows": table_ms,
            f"per_row_ctfs_{MATCH_BATCH}_rows": rows_ms,
            f"phase_flip_{MATCH_BATCH}_views": flip_ms}
        log(f"  on the card: CTF table of a {BATCH}-view batch "
            f"{table_ms:.4f} ms; {MATCH_BATCH} per-row CTFs {rows_ms:.4f} ms; "
            f"phase flip of {MATCH_BATCH} views {flip_ms:.4f} ms")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    log("ctf " + json.dumps(report))
    limit.check()
    return launches


# ---------------------------------------------------------------------------
# phase 7: BASELINE config 1 through the CLI — filter, normalise, align,
# geometry, and the reference-free alignment
# ---------------------------------------------------------------------------

ALIGN_POSE = (30.0, 60.0)        # rot, tilt of the clean view of BLOBS8
ALIGN_SHIFT = 6.0                # shifts uniform in +-6 px per axis at N=128
ALIGN_MAX_SHIFT = 8
ALIGN_LOWPASS = 0.25
ALIGN_BG_RADIUS = 56
ALIGN_FREE_ITERS = 3
# Limits, none looser than asked; the planning runs of the reference
# package (tools/plan_align_2d.py) read them beforehand.
ALIGN_FILTER_TOL = 1e-4          # the filter against a numpy rfft low-pass
ALIGN_BG_TOL = 0.05              # background mean 0 and std 1 after NewXmipp
ALIGN_FLIP_OK = 0.99             # mirror flags right
ALIGN_PSI_DEG, ALIGN_PSI_OK = 2.0, 0.95
ALIGN_SHIFT_MEDIAN_PX = 0.5
ALIGN_AVG_CORR = 0.99            # geometry's average vs image_align's own
ALIGN_CLEAN_CORR = 0.9           # each average, and the reference-free one


def align2d_recipe(n: int, views: int, seed: int):
    """Phase 7's data, drawn with numpy from the seed: the clean view's
    blob centres (BLOBS8 at ALIGN_POSE, centres scaled by n/N, widths kept)
    and each view's 2-D transform G (B,3,3) float64, content moved by G
    (ops.geo's matrices: x-mirror of half the views, then psi uniform on
    [0, 360), then shifts uniform in +-ALIGN_SHIFT*n/N px)."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.ops.geo import alignment_matrices_2d
    A = np.asarray(euler_matrix(*ALIGN_POSE, 0.0), np.float64)
    blobs = []
    for cz, cy, cx, s, a in BLOBS8:
        c = np.array([cx, cy, cz]) * n / N
        blobs.append((A[0] @ c, A[1] @ c, s, a * s * np.sqrt(2 * np.pi)))
    rng = np.random.default_rng(seed + 7)
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-ALIGN_SHIFT, ALIGN_SHIFT, (2, views)) * n / N
    mirror = rng.uniform(size=views) < 0.5
    # content moved by G: G = T(s)·R(psi)·F^mirror (mirror applied first)
    G = alignment_matrices_2d(psi.astype(np.float32), sx.astype(np.float32),
                              sy.astype(np.float32), device="cpu").numpy()
    G = G.astype(np.float64) @ np.where(mirror[:, None, None],
                                        np.diag([-1.0, 1.0, 1.0]), np.eye(3))
    return blobs, G, mirror, rng


def align2d_views(n: int, views: int, seed: int, device, batch: int = 1000):
    """(clean view (n,n), views (V,n,n), G, mirror) as float32 numpy: each
    view the analytic blobs at the centres G moves them to, evaluated on
    `device` a batch at a time, plus Gaussian noise of 0.5 sigma of the
    clean view drawn with numpy."""
    import torch
    blobs, G, mirror, rng = align2d_recipe(n, views, seed)
    c = torch.arange(n, dtype=torch.float64, device=device) - n // 2
    y, x = c[:, None], c[None, :]

    def render(Gb):
        Gb = torch.as_tensor(Gb, device=device)
        out = torch.zeros((len(Gb), n, n), dtype=torch.float64, device=device)
        for px, py, s, amp in blobs:
            qx = (Gb[:, 0, 0] * px + Gb[:, 0, 1] * py + Gb[:, 0, 2])
            qy = (Gb[:, 1, 0] * px + Gb[:, 1, 1] * py + Gb[:, 1, 2])
            out += amp * torch.exp(-((x - qx[:, None, None]) ** 2
                                     + (y - qy[:, None, None]) ** 2)
                                   / (2 * s * s))
        return out.to(torch.float32).cpu().numpy()

    clean = render(np.eye(3)[None])[0]
    imgs = np.concatenate([render(G[lo:lo + batch])
                           for lo in range(0, views, batch)])
    imgs += (0.5 * clean.std()) * rng.standard_normal(imgs.shape,
                                                      dtype=np.float32)
    return clean, imgs, G, mirror


def lowpass_numpy(imgs, w1: float, raised: float = 0.02):
    """The raised-cosine low-pass of transform_filter --fourier low_pass,
    written with numpy's rfft2."""
    n = imgs.shape[-1]
    r = np.hypot(np.fft.fftfreq(n)[:, None], np.fft.rfftfreq(n)[None, :])
    mask = np.where(r <= w1, 1.0, np.where(
        r >= w1 + raised, 0.0,
        0.5 * (1 + np.cos(np.pi * np.clip((r - w1) / raised, 0, 1)))))
    return np.fft.irfft2(np.fft.rfft2(imgs.astype(np.float64)) * mask,
                         s=imgs.shape[-2:])


def registration_errors(rows, G, mirror):
    """(flip right, psi error deg, shift error px) of alignment rows against
    the truth: the rows' registration matrix (ops.geo's metadata
    convention) times the view's transform G must be the identity."""
    from xmipp3_tpu_torch.ops.geo import metadata_alignment_matrices
    col = lambda k: np.array([float(r[k]) for r in rows])
    order = col("itemId").astype(int) - 1
    flip = col("flip") > 0
    M = metadata_alignment_matrices(
        col("anglePsi").astype(np.float32), col("shiftX").astype(np.float32),
        col("shiftY").astype(np.float32), flip, device="cpu").numpy()
    E = M.astype(np.float64) @ G[order]
    psi_err = np.abs(np.degrees(np.arctan2(E[:, 0, 1], E[:, 0, 0])))
    return (flip == mirror[order], psi_err,
            np.hypot(E[:, 0, 2], E[:, 1, 2]))


def align_2d(seed, root: Path):
    """Phase 7 in root: BASELINE config 1 at N=128 on VIEWS views."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops.align import align_considering_mirrors
    from xmipp3_tpu_torch.programs import main as xmipp
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    clean, views, G, mirror = align2d_views(N, VIEWS, seed, DEVICE)
    made = time.perf_counter() - t0
    save_image(str(root / "clean.xmp"), clean)
    save_image(str(root / "views.mrcs"), views)
    log(f"phase 7: {VIEWS} views of one BLOBS8 view (rot, tilt "
        f"{ALIGN_POSE}) at N={N}, made in {made:.2f} s on the card and "
        f"written in {time.perf_counter() - t0 - made:.2f} s "
        f"({views.nbytes / 1e6:.0f} MB)")
    f = lambda name: str(root / name)
    steps = (
        ("filter", "transform_filter",
         ["-i", f("views.mrcs"), "-o", f("filt.mrcs"), "--fourier",
          "low_pass", str(ALIGN_LOWPASS)]),
        ("normalise", "transform_normalize",
         ["-i", f("filt.mrcs"), "-o", f("norm.mrcs"), "--method", "NewXmipp",
          "--background", "circle", str(ALIGN_BG_RADIUS)]),
        ("align", "image_align",
         ["-i", f("norm.mrcs"), "--ref", f("clean.xmp"), "--max_shift",
          str(ALIGN_MAX_SHIFT), "-o", f("aligned.xmd"), "--oaligned",
          f("aligned.mrcs")]),
        ("geometry", "transform_geometry",
         ["-i", f("aligned.xmd"), "-o", f("geo.mrcs"), "--apply_transform"]),
        ("reference-free align", "image_align",
         ["-i", f("norm.mrcs"), "--iter", str(ALIGN_FREE_ITERS),
          "--max_shift", str(ALIGN_MAX_SHIFT), "-o", f("free.xmd"),
          "--oaligned", f("free.mrcs")]))
    report = {}
    limit = Limits(7)

    timing.enable_timing(True)
    torch.cuda.reset_peak_memory_stats()
    try:
        for label, name, args in steps:
            launch_counts(reset=True)
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", name, *args, "--device", DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"phase 7 {label} ({name}): rc {rc}")
            phases, timed = take_phases()
            report[label] = {
                "program": name, "wall_s": wall, "images_per_s": VIEWS / wall,
                "launches": {k: v for k, v in launch_counts().items() if v},
                "phases_s": phases, "rest_s": wall - timed,
                "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
            torch.cuda.reset_peak_memory_stats()
            log(f"  {label} ({name}): {wall:.3f} s, {VIEWS / wall:.1f} "
                f"images/s, peak {report[label]['peak_device_GB']:.2f} GB, "
                "phases " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      phases.items()))
        quality = {}
        load = lambda name: np.squeeze(Image(f(name)).data)

        # the filter against numpy, on 64 views
        filt = load("filt.mrcs")
        check(filt.shape == views.shape and np.isfinite(filt).all(),
              f"phase 7 filter: output of shape {filt.shape}")
        want = lowpass_numpy(views[:64], ALIGN_LOWPASS)
        err = max_rel(filt[:64], want)
        quality["filter_vs_numpy"] = err
        log(f"  filter vs a numpy rfft low-pass (64 views): max |port - "
            f"numpy| / max = {err:.3e}")
        limit(err <= ALIGN_FILTER_TOL, f"phase 7: the filter differs from "
              f"numpy by {err:.3e} > {ALIGN_FILTER_TOL} of the max")
        del filt, want

        # the background after NewXmipp
        norm = load("norm.mrcs")
        c = np.arange(N) - N // 2
        bg = np.hypot(c[:, None], c[None, :]) > ALIGN_BG_RADIUS
        bg_mean = float(norm[:, bg].mean(1).mean())
        bg_std = float(norm[:, bg].std(1).mean())
        quality["background_mean"], quality["background_std"] = bg_mean, \
            bg_std
        log(f"  normalised background: mean {bg_mean:.4f}, std {bg_std:.4f}")
        limit(abs(bg_mean) <= ALIGN_BG_TOL and abs(bg_std - 1) <= ALIGN_BG_TOL,
              f"phase 7: background mean {bg_mean:.4f} / std {bg_std:.4f} "
              f"not within {ALIGN_BG_TOL} of 0 / 1")
        del norm

        # the alignment against the truth
        md = MetaData(f("aligned.xmd"))
        rows = [md.getRow(i) for i in md]
        check(len(rows) == VIEWS, f"phase 7: {len(rows)} alignment rows")
        flip_ok, psi_err, shift_err = registration_errors(rows, G, mirror)
        quality.update({
            "flip_right": float(flip_ok.mean()),
            "psi_within_2_deg": float((psi_err[flip_ok] <= ALIGN_PSI_DEG)
                                      .sum() / VIEWS),
            "median_psi_err_deg": float(np.median(psi_err[flip_ok])),
            "median_shift_err_px": float(np.median(shift_err[flip_ok])),
            "mean_maxCC": float(np.mean([float(r["maxCC"]) for r in rows]))})
        q = quality
        log(f"  align vs the truth: mirror right {q['flip_right']:.4f}, psi "
            f"within {ALIGN_PSI_DEG} deg {q['psi_within_2_deg']:.4f} (median "
            f"{q['median_psi_err_deg']:.3f} deg), median shift error "
            f"{q['median_shift_err_px']:.3f} px, mean maxCC "
            f"{q['mean_maxCC']:.4f}")
        limit(q["flip_right"] >= ALIGN_FLIP_OK, f"phase 7: mirror right for "
              f"{q['flip_right']:.4f} < {ALIGN_FLIP_OK} of the views")
        limit(q["psi_within_2_deg"] >= ALIGN_PSI_OK, f"phase 7: psi within "
              f"{ALIGN_PSI_DEG} deg for {q['psi_within_2_deg']:.4f} < "
              f"{ALIGN_PSI_OK}")
        limit(q["median_shift_err_px"] <= ALIGN_SHIFT_MEDIAN_PX, "phase 7: "
              f"median shift error {q['median_shift_err_px']:.3f} px > "
              f"{ALIGN_SHIFT_MEDIAN_PX}")

        # the pose convention end to end: the geometry of the written rows
        # against image_align's own aligned stack
        aligned_avg = load("aligned.mrcs").mean(0)
        geo_avg = load("geo.mrcs").mean(0)
        free_avg = load("free_avg.mrcs")
        quality["geo_vs_aligned_avg"] = real_corr(geo_avg, aligned_avg)
        quality["aligned_avg_vs_clean"] = real_corr(aligned_avg, clean)
        quality["geo_avg_vs_clean"] = real_corr(geo_avg, clean)
        _, _, _, flip, corr, _ = align_considering_mirrors(
            clean, free_avg[None], n_iters=3, max_shift=ALIGN_MAX_SHIFT,
            device=DEVICE)
        quality["free_avg_vs_clean"] = float(corr[0])
        quality["free_avg_mirrored"] = bool(flip[0])
        log(f"  averages: geometry vs aligned {q['geo_vs_aligned_avg']:.4f}; "
            f"vs the clean view: aligned {q['aligned_avg_vs_clean']:.4f}, "
            f"geometry {q['geo_avg_vs_clean']:.4f}, reference-free "
            f"(registered, mirrored {q['free_avg_mirrored']}) "
            f"{q['free_avg_vs_clean']:.4f}")
        limit(q["geo_vs_aligned_avg"] >= ALIGN_AVG_CORR, "phase 7: the "
              "geometry's average correlates "
              f"{q['geo_vs_aligned_avg']:.4f} < {ALIGN_AVG_CORR} with "
              "image_align's")
        for key in ("aligned_avg_vs_clean", "geo_avg_vs_clean",
                    "free_avg_vs_clean"):
            limit(q[key] >= ALIGN_CLEAN_CORR, f"phase 7: {key} {q[key]:.4f} "
                  f"< {ALIGN_CLEAN_CORR}")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
        shutil.rmtree(root, ignore_errors=True)
    log("align2d " + json.dumps(report))
    limit.check()


# ---------------------------------------------------------------------------
# phase 8: BASELINE config 2 through the CLI — CTF estimation from
# micrographs and PSDs
# ---------------------------------------------------------------------------

EST_SIZE = 4096          # the frame of a 4k detector (Falcon II, EMPIAR-10028)
EST_TS = 1.34            # A/px
EST_KV, EST_CS, EST_Q0 = 300.0, 2.7, 0.07
EST_A = (18000.0, 16000.0, 35.0)       # micrograph A: defocusU, V, azimuth
EST_B_MEAN = 15000.0                   # micrograph B: the plane's mean (A)
EST_B_SLOPE = (1500.0, -800.0)         # its change across the frame, x and y
EST_BLOCK = 512                        # B's blocks: the regions' grid
EST_PARTICLES = 300
# the envelope's convergence cone and the background of the reference's
# synthetic PSDs (tests/test_ctf_full_estimation.py:17-31)
EST_ALPHA = 2e-4
EST_BG = dict(base=0.1, sqrt_K=3.0, sqU=12.0, sqV=14.0, sqrt_angle=20.0,
              gK=1.5, sigmaU=8000.0, sigmaV=9000.0, cU=0.02, cV=0.022,
              g_angle=10.0)
EST_PSD_TOL = 1e-4      # the port's PSD (float32) against numpy (float64)
EST_DEFOCUS_TOL = 0.02  # A and from_psd: the reference's own limits,
EST_ANGLE_TOL = 5.0     # tests/test_ctf_full_estimation.py:34-43
EST_1D_TOL = 0.05       # the 1-D fit on the mean defocus
# planned with tools/plan_ctf_estimate.py --particles 300 (the reference
# on a CPU, a 2048^2 frame: the regions' worst 0.0166, the plane at the
# centre 0.0003, the particles' worst 0.0297 of the plant)
EST_REGION_TOL = 0.04   # each region's defocusU/V against its block's
EST_PLANE_TOL = 0.01    # the plane at B's centre against the plant's
EST_PARTICLE_TOL = 0.06  # each particle's defocusU/V against A's


def est_spectra(n: int, Ts: float, dfu: float, dfv: float, az_deg: float):
    """(CTF times its envelope, background power) of one micrograph on the
    rfft2 grid of an n x n image, float64 numpy, written out here as
    plant_ctf is: the envelope of the reference's synthetic CTF (no
    chromatic term) is the cone's, E = exp(-pi^2 alpha^2 (Cs lambda^2 u^3
    + df(theta) u)^2); the background is base + gK exp(-sigma(theta)
    (u - c(theta))^2) + sqrtK exp(-sq(theta) sqrt(u)), each (theta)
    parameter elliptical between its U and V values."""
    fy = np.fft.fftfreq(n)[:, None] / Ts
    fx = np.fft.rfftfreq(n)[None, :] / Ts
    u = np.sqrt(fx * fx + fy * fy)
    theta = np.arctan2(fy, fx)
    v = EST_KV * 1e3
    lam = 12.2643247 / np.sqrt(v * (1 + 0.978466e-6 * v))
    df = -(dfu + dfv) / 2 - (dfu - dfv) / 2 * np.cos(
        2 * (theta - np.deg2rad(az_deg)))
    env = np.exp(-(np.pi * EST_ALPHA) ** 2
                 * (EST_CS * 1e7 * lam ** 2 * u ** 3 + df * u) ** 2)
    ctf = plant_ctf(n, Ts, dfu, dfv, az_deg, EST_KV, EST_CS, EST_Q0) * env

    def ellip(a, b, ang):
        c2 = np.cos(2 * (theta - np.deg2rad(ang)))
        return np.sqrt(a * a * (1 + c2) / 2 + b * b * (1 - c2) / 2)

    g = EST_BG
    bg = (g["base"] + g["gK"] * np.exp(
        -ellip(g["sigmaU"], g["sigmaV"], g["g_angle"])
        * (u - ellip(g["cU"], g["cV"], g["g_angle"])) ** 2)
        + g["sqrt_K"] * np.exp(-ellip(g["sqU"], g["sqV"], g["sqrt_angle"])
                               * np.sqrt(u)))
    return ctf, bg


def est_plant(n: int, Ts: float, dfu: float, dfv: float, az_deg: float,
              rng) -> np.ndarray:
    """An n x n micrograph: complex white noise times the CTF (envelope
    included) plus the background's power, in Fourier space, transformed
    back (float32)."""
    ctf, bg = est_spectra(n, Ts, dfu, dfv, az_deg)
    z = lambda: rng.standard_normal(ctf.shape) \
        + 1j * rng.standard_normal(ctf.shape)
    spec = z() * ctf + z() * np.sqrt(bg)
    return (np.fft.irfft2(spec, s=(n, n)) * n).astype(np.float32)


def est_block_defocus(i: int, j: int, size: int = EST_SIZE):
    """(defocusU, defocusV) of micrograph B's block (row i, column j): the
    tilted plane's value at the block's centre, with A's astigmatism. The
    plane's slopes are those of the full frame at any size."""
    yc, xc = (i + 0.5) * EST_BLOCK, (j + 0.5) * EST_BLOCK
    d = (EST_B_MEAN + EST_B_SLOPE[0] * (xc - size / 2) / EST_SIZE
         + EST_B_SLOPE[1] * (yc - size / 2) / EST_SIZE)
    half = (EST_A[0] - EST_A[1]) / 2
    return d + half, d - half


def est_data(size: int, particles: int, seed: int):
    """Micrographs A (one defocus) and B (blocks on a tilted plane) of
    size x size, and particle positions (x, y), all from the seed."""
    rng = np.random.default_rng(seed)
    A = est_plant(size, EST_TS, *EST_A, rng)
    nb = size // EST_BLOCK
    B = np.empty((size, size), np.float32)
    for i in range(nb):
        for j in range(nb):
            u, v = est_block_defocus(i, j, size)
            B[i * EST_BLOCK:(i + 1) * EST_BLOCK,
              j * EST_BLOCK:(j + 1) * EST_BLOCK] = est_plant(
                EST_BLOCK, EST_TS, u, v, EST_A[2], rng)
    pos = rng.integers(0, size, (particles, 2))
    return A, B, pos


def est_window(n: int, overlap_frac: float = 0.5) -> np.ndarray:
    """The programs' raised-cosine piece window, in float64 numpy."""
    ramp = int(n * overlap_frac / 2)
    w = np.ones(n)
    t = 0.5 * (1 - np.cos(np.pi * (np.arange(ramp) + 0.5) / ramp))
    w[:ramp], w[-ramp:] = t, t[::-1]
    return w


def est_psd_numpy(mic: np.ndarray, piece: int = EST_BLOCK,
                  overlap: float = 0.5) -> np.ndarray:
    """The micrograph mode's PSD in float64 numpy: the mean over the
    overlapped tiles of |FFT(tile * window)|^2 / piece^2 on the full
    plane, centred."""
    step = int(piece * (1 - overlap))
    pos = list(range(0, mic.shape[0] - piece + 1, step))
    if pos[-1] != mic.shape[0] - piece:
        pos.append(mic.shape[0] - piece)
    w = est_window(piece)
    w2 = w[:, None] * w[None, :]
    acc = np.zeros((piece, piece))
    for y0 in pos:
        for x0 in pos:
            t = mic[y0:y0 + piece, x0:x0 + piece].astype(np.float64)
            acc += np.abs(np.fft.fft2(t * w2)) ** 2
    return np.fft.fftshift(acc / (len(pos) ** 2 * piece * piece))


def est_angle_err(a: float, b: float) -> float:
    d = abs(a - b) % 180.0
    return min(d, 180.0 - d)


def ctf_estimation(seed, root: Path):
    """Phase 8 in root: BASELINE config 2 at a 4k frame's size."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.models import ctf_estimation as ce
    from xmipp3_tpu_torch.programs import get_program
    root.mkdir(parents=True)
    f = lambda name: str(root / name)
    t0 = time.perf_counter()
    A, B, pos = est_data(EST_SIZE, EST_PARTICLES, seed)
    made = time.perf_counter() - t0
    save_image(f("A.mrc"), A)
    save_image(f("B.mrc"), B)
    MetaData.fromRows({"xcoor": int(x), "ycoor": int(y)} for x, y in pos) \
        .write(f("pos.xmd"))
    MetaData.fromRows(
        {"ctfDefocusU": float(u), "ctfDefocusV": float(v),
         "ctfDefocusAngle": float(az), "ctfSamplingRate": CTF_TS,
         "ctfVoltage": CTF_KV, "ctfSphericalAberration": CTF_CS,
         "ctfQ0": CTF_Q0} for u, v, az in zip(*ctf_recipe())) \
        .write(f("ctfdat.xmd"))
    log(f"phase 8: micrographs A and B of {EST_SIZE}^2 at {EST_TS} A/px made "
        f"in {made:.2f} s with numpy and written in "
        f"{time.perf_counter() - t0 - made:.2f} s; {EST_PARTICLES} particle "
        "positions")
    fit = ["--sampling_rate", str(EST_TS), "--kV", str(EST_KV), "--Cs",
           str(EST_CS), "--Q0", str(EST_Q0)]

    def sort_input():
        MetaData.fromRows([{"micrograph": f("A.mrc"), "psd": f("A.psd"),
                            "ctfModel": f("A.ctfparam")}]).write(
            f("sort.xmd"))

    steps = (
        ("micrograph", "ctf_estimate_from_micrograph",
         ["--micrograph", f("A.mrc"), "--oroot", f("A")] + fit, None),
        ("regions", "ctf_estimate_from_micrograph",
         ["--micrograph", f("B.mrc"), "--oroot", f("B"), "--mode",
          "regions"] + fit, None),
        ("particles", "ctf_estimate_from_micrograph",
         ["--micrograph", f("A.mrc"), "--oroot", f("P"), "--mode",
          "particles", f("pos.xmd")] + fit, None),
        ("from_psd", "ctf_estimate_from_psd",
         ["--psd", f("A.psd"), "-o", f("A_fp.ctfparam")] + fit, None),
        ("from_psd_fast", "ctf_estimate_from_psd_fast",
         ["--psd", f("A.psd"), "-o", f("A_fast.ctfparam")] + fit, None),
        ("psd_estimate", "psd_estimate",
         ["-i", f("A.mrc"), "-o", f("A_pe.xmp")], None),
        ("enhance", "ctf_enhance_psd",
         ["-i", f("A.psd"), "-o", f("A_enh.xmp")], None),
        ("sort", "ctf_sort_psds", ["-i", f("sort.xmd"), "-o",
                                   f("sorted.xmd")], sort_input),
        ("group", "ctf_group", ["--ctfdat", f("ctfdat.xmd"), "--oroot",
                                f("grp"), "--wiener"], None))
    report = {}
    limit = Limits(8)

    timing.enable_timing(True)
    try:
        for label, name, args, before in steps:
            if before is not None:
                before()
            launch_counts(reset=True)
            timing.take_timing()
            ce.compass_stats.update(calls=0, rounds=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prog = get_program(name)
            t0 = time.perf_counter()
            rc = prog.run_with_args(args + ["--device", DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"phase 8 {label} ({name}): rc {rc}")
            phases, timed = take_phases()
            compass = phases.pop("compass rounds", 0.0)
            report[label] = {
                "program": name, "wall_s": wall, "phases_s": phases,
                "rest_s": wall - timed,
                "compass_s": compass,
                "compass_rounds": ce.compass_stats["rounds"],
                "compass_calls": ce.compass_stats["calls"],
                "fitness": getattr(prog, "fitness", None),
                "launches": {k: v for k, v in launch_counts().items() if v},
                "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
            r = report[label]
            log(f"  {label} ({name}): {wall:.3f} s, peak "
                f"{r['peak_device_GB']:.2f} GB, compass {compass:.3f} s in "
                f"{r['compass_rounds']} rounds ({r['compass_calls']} "
                f"searches), fitness {r['fitness']}, phases "
                + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
                + f", rest {r['rest_s']:.3f}")
            check(not r["launches"], f"phase 8 {label}: launched "
                  f"{r['launches']}")
        quality = {}
        load = lambda name: np.squeeze(Image(f(name)).data)
        row = lambda name: (lambda md: md.getRow(md.firstObject()))(
            MetaData(f(name)))
        rel = lambda got, want: abs(got - want) / abs(want)

        # A's PSD against numpy
        psd = load("A.psd")
        want = est_psd_numpy(A)
        err = max_rel(psd, want)
        quality["psd_vs_numpy"] = err
        log(f"  A's PSD vs a numpy periodogram of the same tiles: max |port "
            f"- numpy| / max = {err:.3e}")
        limit(err <= EST_PSD_TOL, f"phase 8: A's PSD differs from numpy by "
              f"{err:.3e} > {EST_PSD_TOL} of the max")

        # A's fits: micrograph mode, from_psd, the 1-D fit
        for key, fn in (("micrograph", "A.ctfparam"),
                        ("from_psd", "A_fp.ctfparam")):
            r = row(fn)
            eu = rel(r["ctfDefocusU"], EST_A[0])
            ev = rel(r["ctfDefocusV"], EST_A[1])
            ea = est_angle_err(r["ctfDefocusAngle"], EST_A[2])
            quality[key] = {"defocusU": r["ctfDefocusU"],
                            "defocusV": r["ctfDefocusV"],
                            "angle": r["ctfDefocusAngle"], "err_U": eu,
                            "err_V": ev, "err_angle_deg": ea}
            log(f"  {key}: defocusU {r['ctfDefocusU']:.1f} ({eu:.4f}), "
                f"defocusV {r['ctfDefocusV']:.1f} ({ev:.4f}), angle "
                f"{r['ctfDefocusAngle']:.2f} ({ea:.2f} deg)")
            limit(max(eu, ev) <= EST_DEFOCUS_TOL and ea <= EST_ANGLE_TOL,
                  f"phase 8 {key}: defocus off by {eu:.4f} / {ev:.4f} "
                  f"(limit {EST_DEFOCUS_TOL}), angle by {ea:.2f} deg")
        r = row("A_fast.ctfparam")
        e1 = rel(0.5 * (r["ctfDefocusU"] + r["ctfDefocusV"]),
                 0.5 * (EST_A[0] + EST_A[1]))
        quality["from_psd_fast"] = {"defocus": r["ctfDefocusU"], "err": e1}
        log(f"  from_psd_fast: defocus {r['ctfDefocusU']:.1f} ({e1:.4f} of "
            "the mean)")
        limit(e1 <= EST_1D_TOL, f"phase 8: the 1-D fit is off by {e1:.4f}")

        # B's regions and the plane at its centre
        md = MetaData(f("B_regions.xmd"))
        errs = []
        for i in md:
            g = md.getRow(i)
            u, v = est_block_defocus(int(g["ycoor"]) // EST_BLOCK,
                                     int(g["xcoor"]) // EST_BLOCK)
            errs.append(max(rel(g["ctfDefocusU"], u),
                            rel(g["ctfDefocusV"], v)))
        r = row("B.ctfparam")
        half = (EST_A[0] - EST_A[1]) / 2
        ep = max(rel(r["ctfDefocusU"], EST_B_MEAN + half),
                 rel(r["ctfDefocusV"], EST_B_MEAN - half))
        quality["regions"] = {"count": len(errs), "max_err": max(errs),
                              "median_err": float(np.median(errs)),
                              "plane_U": r["ctfDefocusU"],
                              "plane_V": r["ctfDefocusV"], "plane_err": ep}
        log(f"  regions: {len(errs)}, worst {max(errs):.4f}, median "
            f"{np.median(errs):.4f} of the block's defocus; the plane at "
            f"B's centre {r['ctfDefocusU']:.1f} / {r['ctfDefocusV']:.1f} "
            f"({ep:.4f})")
        limit(len(errs) == 16, f"phase 8: {len(errs)} regions, not 16")
        limit(max(errs) <= EST_REGION_TOL, f"phase 8: a region is off by "
              f"{max(errs):.4f} > {EST_REGION_TOL}")
        limit(ep <= EST_PLANE_TOL, f"phase 8: the plane at B's centre is off "
              f"by {ep:.4f} > {EST_PLANE_TOL}")

        # the particles
        md = MetaData(f("P_particles.xmd"))
        errs = []
        for i in md:
            r = row(md.getRow(i)["ctfModel"])
            errs.append(max(rel(r["ctfDefocusU"], EST_A[0]),
                            rel(r["ctfDefocusV"], EST_A[1])))
        quality["particles"] = {"count": len(errs), "max_err": max(errs),
                                "median_err": float(np.median(errs)),
                                "p95_err": float(np.percentile(errs, 95))}
        log(f"  particles: {len(errs)}, worst {max(errs):.4f}, 95th "
            f"percentile {np.percentile(errs, 95):.4f}, median "
            f"{np.median(errs):.4f} of A's defocus")
        limit(len(errs) == EST_PARTICLES, f"phase 8: {len(errs)} particles")
        limit(max(errs) <= EST_PARTICLE_TOL, f"phase 8: a particle is off "
              f"by {max(errs):.4f} > {EST_PARTICLE_TOL}")

        # the PSD programs' outputs
        for name, shape in (("A_pe.xmp", (384, 384)),
                            ("A_enh.xmp", (EST_BLOCK, EST_BLOCK)),
                            ("grp_ctf.mrcs", None), ("grp_wien.mrcs", None)):
            img = load(name)
            limit(np.isfinite(img).all() and (shape is None
                                               or img.shape == shape),
                  f"phase 8: {name} of shape {img.shape}, finite "
                  f"{np.isfinite(img).all()}")
        crits = {k: v for k, v in row("sorted.xmd").items()
                 if k.startswith("ctfCrit")}
        quality["sort_criteria"] = len(crits)
        limit(len(crits) >= 15 and all(np.isfinite(list(crits.values()))),
              f"phase 8: ctf_sort_psds wrote {len(crits)} criteria")
        groups = {r["defGroup"] for r in
                  (MetaData(f("grp.xmd")).getRow(i)
                   for i in MetaData(f("grp.xmd")))}
        quality["groups"] = len(groups)
        limit(len(groups) >= 2, f"phase 8: ctf_group made {len(groups)} "
              "groups of 20 CTFs")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
        if (root / "A.mrc").is_file():      # phase 18 previews it
            shutil.move(str(root / "A.mrc"), str(root.parent / BD_MIC))
        shutil.rmtree(root, ignore_errors=True)
    log("ctfest " + json.dumps(report))
    limit.check()


# ---------------------------------------------------------------------------
# phase 9: BASELINE config 5 - movie alignment (the FlexAlign path) and
# MonoRes, through the CLI
# ---------------------------------------------------------------------------

MOVIE_SIZE, MOVIE_FRAMES = 4096, 40   # phantom_movie's own default: a 4k
                                      # detector, 40 frames
# the gain movie: phantom_movie at a dose of 30 e/px a frame (at the
# default 1 e/px the frames are small integers whose ties leave the
# rank-histogram estimate no signal: tools/plan_movie_monores.py), 16
# frames, every MOVIE_GAIN_STEP-th used
MOVIE_GAIN_DOSE, MOVIE_GAIN_FRAMES, MOVIE_GAIN_STEP = 30, 16, 4
MOVIE_GAIN_AMP = (0.1, 0.05)          # planted gain: column and row spread
MOVIE_BAND = (0.01, 0.1)              # cycles/px that the scene fills
MONO_N, MONO_TS = 256, 1.0            # the half maps: 256^3 at 1 A/px
# (inner radius, outer radius) in px at MONO_N and the planted resolution
# in A at MONO_TS; at another size the radii scale with n and the
# resolutions with the sampling (the same digital frequencies)
MONO_ZONES = ((0.0, 40.0, 3.0), (40.0, 70.0, 5.0), (70.0, 100.0, 8.0))
MONO_NOISE = 0.3                      # each half's noise / the signal's
MONO_ANISO = (0.3, 0.1)               # FSO's pairs: one white signal low-
                                      # passed at 0.3 cycles/px, or inside
                                      # the ellipsoid of (kx,ky) and kz
                                      # semi-axes 0.3 and 0.1
MONO_TOMO_SLAB = 64                   # z planes of the tomogram-shaped pair
MOVIE_MESH_TOL = 1e-3                 # px: mesh field vs serial, and the
                                      # global positions of two runs
DOSE_TOL = 1e-4                       # the dose filter against numpy
# limits: about twice what tools/plan_movie_monores.py reads of the
# reference package on the CPU with the same recipe at 1024^2 x 40 frames
# and 128^3 (my CPU run, PERF.md section 6): positions 0.0085 (median) and
# 0.0342 (worst) samples of the 512 correlation grid, 8 px a sample here;
# the band-power ratio 1.082, the gain's correlation 0.925, the zones'
# medians 1.219 / 1.000 / 0.989 of their plants (each limit no tighter than
# one band of the 256^3 sweep, zone_tolerances), the FSO spreads 0.0156
# (two shells) and 0.172 cycles/px
MOVIE_POS_MEDIAN_PX = 0.137
MOVIE_POS_WORST_PX = 0.547
MOVIE_BAND_RATIO = 1.04
MOVIE_GAIN_CORR = 0.85
MONO_ZONE_TOL = (0.44, 0.076, 0.121)
FSO_SPAN_ISO_MAX = 0.0313
FSO_SPAN_ANISO_MIN = 0.086


def movie_gain(h: int, w: int, seed: int) -> np.ndarray:
    """The planted gain (Observed = Ideal * Gain): a gain per column times
    a gain per row, 1 + MOVIE_GAIN_AMP * N(0, 1), the column and row
    defects that the rank-histogram estimate compares neighbouring
    columns and rows for (a gain that varies slowly across the frame is
    the same in neighbouring columns and so invisible to it)."""
    ac, ar = MOVIE_GAIN_AMP
    rng = np.random.default_rng(seed)
    col = 1 + ac * rng.standard_normal(w)
    row = 1 + ar * rng.standard_normal(h)
    return (row[:, None] * col[None, :]).astype(np.float32)


def band_power(img, band=MOVIE_BAND) -> float:
    """Power of an image in a ring of frequencies (cycles/px), float64."""
    img = np.asarray(img, np.float64)
    f = np.sqrt(np.fft.fftfreq(img.shape[0])[:, None] ** 2
                + np.fft.rfftfreq(img.shape[1])[None, :] ** 2)
    sel = (f >= band[0]) & (f <= band[1])
    return float((np.abs(np.fft.rfft2(img - img.mean())) ** 2)[sel].sum())


def position_errors(est, truth):
    """(median, worst) |estimated - true| frame position in px, both in
    the gauge of mean position 0, over frames and axes."""
    truth = np.asarray(truth, np.float64)
    err = np.abs(np.asarray(est) - (truth - truth.mean(axis=0)))
    return float(np.median(err)), float(err.max())


def _lowpass_3d(spec, keep, n: int):
    """The n^3 volume of the rfftn spectrum `spec` inside `keep`."""
    return np.fft.irfftn(spec * keep, s=(n, n, n), axes=(0, 1, 2))


def mono_halves(n: int, seed: int):
    """Two half maps of n^3 voxels at MONO_TS * MONO_N / n A/px: white
    noise inside a sphere, each zone of MONO_ZONES low-passed (ideal
    filter) to its planted resolution, plus independent noise of
    MONO_NOISE per half; with the sphere (the mask), the zones' masks and
    the sampling. numpy, from `seed`."""
    Ts = MONO_TS * MONO_N / n
    rng = np.random.default_rng(seed)
    z, y, x = (np.arange(n) - n // 2 for _ in range(3))
    rad = np.sqrt(z[:, None, None] ** 2 + y[None, :, None] ** 2
                  + x[None, None, :] ** 2)
    f = np.sqrt(np.fft.fftfreq(n)[:, None, None] ** 2
                + np.fft.fftfreq(n)[None, :, None] ** 2
                + np.fft.rfftfreq(n)[None, None, :] ** 2)
    white = np.fft.rfftn(rng.standard_normal((n, n, n)))
    signal = np.zeros((n, n, n))
    zones = []
    for r0, r1, res in MONO_ZONES:
        zone = (rad >= r0 * n / MONO_N) & (rad < r1 * n / MONO_N)
        signal[zone] = _lowpass_3d(white, f <= MONO_TS / res, n)[zone]
        zones.append(zone)
    mask = rad < MONO_ZONES[-1][1] * n / MONO_N
    halves = [(signal + MONO_NOISE * rng.standard_normal(signal.shape))
              .astype(np.float32) for _ in range(2)]
    return halves, mask, zones, Ts


def fso_pairs(n: int, seed: int):
    """FSO's isotropic and anisotropic pairs of n^3 half maps: white noise
    inside MONO_ZONES' outer sphere, low-passed inside the sphere of
    radius MONO_ANISO[0] cycles/px or inside the ellipsoid (kx^2 + ky^2)/a^2
    + kz^2/c^2 <= 1 of MONO_ANISO, each half with independent noise of
    MONO_NOISE. numpy, from `seed`."""
    a, c = MONO_ANISO
    rng = np.random.default_rng(seed + 1)
    z, y, x = (np.arange(n) - n // 2 for _ in range(3))
    rad = np.sqrt(z[:, None, None] ** 2 + y[None, :, None] ** 2
                  + x[None, None, :] ** 2)
    white = np.fft.rfftn(rng.standard_normal((n, n, n)) * (
        rad < MONO_ZONES[-1][1] * n / MONO_N))
    fz = np.fft.fftfreq(n)[:, None, None]
    fy = np.fft.fftfreq(n)[None, :, None]
    fx = np.fft.rfftfreq(n)[None, None, :]
    pairs = {}
    for key, keep in (("iso", fx ** 2 + fy ** 2 + fz ** 2 <= a ** 2),
                      ("aniso", (fx ** 2 + fy ** 2) / a ** 2
                       + fz ** 2 / c ** 2 <= 1)):
        signal = _lowpass_3d(white, keep, n)
        pairs[key] = [(signal + MONO_NOISE * rng.standard_normal(
            signal.shape)).astype(np.float32) for _ in range(2)]
    return pairs


def fso_span(fso) -> float:
    """The width in cycles/px of the shells whose FSO lies strictly between
    0.1 and 0.9: how far the directional resolutions spread."""
    fso = np.asarray(fso)
    return float(((fso > 0.1) & (fso < 0.9)).sum() * 0.5 / len(fso))


def zone_tolerances():
    """Per zone, the relative width of one MonoRes band at its planted
    frequency in phase 9's sweep (the default: 30 bands from 3 / MONO_N to
    0.45 cycles/px): the least difference the map can show."""
    f_lo, f_hi = 3.0 / MONO_N, min(1 / 2.2, 0.45)
    step = (f_hi - f_lo) / 29
    return [step / (MONO_TS / res) for _, _, res in MONO_ZONES]


def zone_medians(res_map, zones, Ts):
    """Per zone, the median local resolution (A) and its ratio to the
    planted one at sampling Ts."""
    out = []
    for zone, (_, _, res) in zip(zones, MONO_ZONES):
        planted = res * Ts / MONO_TS
        med = float(np.median(res_map[zone]))
        out.append({"planted_A": planted, "median_A": med,
                    "ratio": med / planted})
    return out


def dose_numpy(frame, n: int, dose: float, Ts: float) -> np.ndarray:
    """Frame n (0-based) of a movie weighted by the Grant & Grigorieff
    critical-exposure fit at 300 kV, in float64 numpy: the plain version
    of movie_filter_dose."""
    H, W = frame.shape
    k = np.maximum(np.sqrt(np.fft.fftfreq(H)[:, None] ** 2
                           + np.fft.rfftfreq(W)[None, :] ** 2) / Ts, 1e-6)
    q = np.exp(-dose * (n + 1) / (2.0 * (0.24499 * k ** -1.6649 + 2.8141)))
    return np.fft.irfft2(np.fft.rfft2(np.asarray(frame, np.float64)) * q,
                         s=(H, W))


def movie_monores(seed, root: Path):
    """Phase 9 in root: BASELINE config 5 - the movie path at a 4k
    detector's size and the MonoRes programs on 256^3 half maps."""
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    root.mkdir(parents=True)
    f = lambda name: str(root / name)
    load = lambda name: np.squeeze(Image(f(name)).data)
    report, quality = {}, {}
    limit = Limits(9)

    def run(label, name, args):
        prog = run_program(9, report, label, name, args)
        check(not report[label]["launches"], f"phase 9 {label}: launched "
              f"{report[label]['launches']}")
        return prog

    def shifts(name):
        md = MetaData(f(name))
        return np.stack([md.getColumn("shiftX"), md.getColumn("shiftY")], 1)

    S, F = MOVIE_SIZE, MOVIE_FRAMES
    start = time.perf_counter()
    timing.enable_timing(True)
    try:
        log(f"phase 9: phantom_movie -size {S} {S} {F} --seed {seed} (ice, "
            "dose and barrel distortion at their defaults)")
        run("phantom", "phantom_movie", ["-o", f("movie.mrcs"), "-size", S,
                                         S, F, "--seed", seed])
        # the movie path: defaults (7 x 7 patches, --patchesAvg 3)
        prog = run("align", "movie_alignment_correlation",
                   ["-i", f("movie.mrcs"), "-o", f("shifts.xmd"), "--oavg",
                    f("avg.mrc"), "--oavgInitial", f("avg0.mrc")])
        field = np.asarray(prog.field)
        med, worst = position_errors(shifts("shifts.xmd"),
                                     shifts("movie_gt.xmd"))
        ratio = band_power(load("avg.mrc")) / band_power(load("avg0.mrc"))
        quality["align"] = {"pos_median_px": med, "pos_worst_px": worst,
                            "band_power_ratio": ratio,
                            "field_max_px": float(np.abs(field).max())}
        log(f"  global positions vs the truth: median {med:.4f} px, worst "
            f"{worst:.4f} px; aligned / initial average's power in "
            f"{MOVIE_BAND} cycles/px {ratio:.4f}; local field up to "
            f"{np.abs(field).max():.3f} px")
        limit(med <= MOVIE_POS_MEDIAN_PX and worst <= MOVIE_POS_WORST_PX,
              f"phase 9: positions off by {med:.4f} / {worst:.4f} px "
              f"(limits {MOVIE_POS_MEDIAN_PX} / {MOVIE_POS_WORST_PX})")
        limit(ratio >= MOVIE_BAND_RATIO, f"phase 9: the aligned average's "
              f"band power is {ratio:.4f} x the initial's < "
              f"{MOVIE_BAND_RATIO}")
        # the global-plus-dose path and the kept stack
        run("align_global_dose", "movie_alignment_correlation",
            ["-i", f("movie.mrcs"), "-o", f("shifts_g.xmd"), "--oavg",
             f("avg_dose.mrc"), "--skipLocalAlignment", "--dose_per_frame",
             "1", "--oaligned", f("aligned.mrcs")])
        same = float(np.abs(shifts("shifts_g.xmd")
                            - shifts("shifts.xmd")).max())
        kept = Image.read_stack(f("aligned.mrcs"))
        quality["align_global_dose"] = {"max_pos_diff_px": same}
        limit(same <= MOVIE_MESH_TOL and kept.shape == (F, S, S)
              and np.isfinite(kept).all() and np.isfinite(
                  load("avg_dose.mrc")).all(),
              f"phase 9: the global run's positions differ by {same:.2e} px "
              f"or its stack {kept.shape} is not finite")
        del kept
        os.remove(f("aligned.mrcs"))
        # the mesh path: the patch axis over two gloo ranks on the card
        mesh_dir = root / "mesh"
        mesh_dir.mkdir()
        wall, reps = run_ranks("movie_alignment_correlation",
                               ["-i", f("movie.mrcs"), "-o", f("mesh.xmd"),
                                "--oavg", f("avg_mesh.mrc"), "--mesh", "dp"],
                               2, mesh_dir)
        err = max(float(np.abs(np.asarray(rep["field"]) - field).max())
                  for rep in reps)
        report["mesh"] = {"wall_s": wall, "per_rank": [
            {k: v for k, v in rep.items() if k != "field"} for rep in reps]}
        quality["mesh"] = {"field_max_diff_px": err}
        log(f"  movie_alignment_correlation --mesh dp over 2 ranks: "
            f"{wall:.3f} s, field within {err:.2e} px of the serial one; "
            + "; ".join(f"rank {r} {rep['wall_s']:.3f} s, peak "
                        f"{rep['peak_device_GB']:.2f} GB" for r, rep in
                        enumerate(reps)))
        limit(err <= MOVIE_MESH_TOL, f"phase 9: the mesh field differs from "
              f"the serial one by {err:.2e} px > {MOVIE_MESH_TOL}")
        # dose weighting against numpy
        run("filter_dose", "movie_filter_dose",
            ["-i", f("movie.mrcs"), "-o", f("dosef.mrcs"), "--dosePerFrame",
             "1", "--sampling", "1"])
        raw, got = Image.read_stack(f("movie.mrcs")), \
            Image.read_stack(f("dosef.mrcs"))
        derr = 0.0
        for n in (0, F - 1):
            want = dose_numpy(raw[n], n, 1.0, 1.0)
            derr = max(derr, max_rel(got[n], want))
        quality["filter_dose_vs_numpy"] = derr
        log(f"  movie_filter_dose frames 0 and {F - 1} vs numpy: "
            f"{derr:.3e} of the max")
        limit(derr <= DOSE_TOL, f"phase 9: the dose filter differs from "
              f"numpy by {derr:.3e}")
        del raw, got
        for name in ("movie.mrcs", "dosef.mrcs"):
            os.remove(f(name))
        # the gain: column and row defects planted on a higher-dose movie
        run("phantom_gain", "phantom_movie",
            ["-o", f("gm.mrcs"), "-size", S, S, MOVIE_GAIN_FRAMES, "--seed",
             seed, "--dose", MOVIE_GAIN_DOSE])
        gain = movie_gain(S, S, seed)
        save_image(f("gained.mrcs"), Image.read_stack(f("gm.mrcs"))
                   * gain[None])
        prog = run("gain", "movie_estimate_gain",
                   ["-i", f("gained.mrcs"), "--oroot", f("g"),
                    "--frameStep", MOVIE_GAIN_STEP])
        corr = float(np.corrcoef(prog.gain.ravel(),
                                 (1.0 / gain).ravel())[0, 1])
        quality["gain_corr"] = corr
        log(f"  the estimated inverse gain correlates {corr:.4f} with the "
            "planted one")
        limit(corr >= MOVIE_GAIN_CORR, f"phase 9: the gain correlates "
              f"{corr:.4f} < {MOVIE_GAIN_CORR}")
        for name in ("gm.mrcs", "gained.mrcs"):
            os.remove(f(name))

        # the volume side
        t0 = time.perf_counter()
        halves, mask, zones, Ts = mono_halves(MONO_N, seed)
        pairs = fso_pairs(MONO_N, seed)
        mean = 0.5 * (halves[0] + halves[1])
        k = MONO_TOMO_SLAB // 2
        sl = slice(MONO_N // 2 - k, MONO_N // 2 + k)
        for name, v in (("h1", halves[0]), ("h2", halves[1]), ("mean", mean),
                        ("i1", pairs["iso"][0]), ("i2", pairs["iso"][1]),
                        ("a1", pairs["aniso"][0]), ("a2", pairs["aniso"][1]),
                        ("mask", mask.astype(np.float32)),
                        ("t1", halves[0][sl]), ("t2", halves[1][sl]),
                        ("tmask", mask[sl].astype(np.float32))):
            save_image(f(f"{name}.vol"), v)
        log(f"  half maps of {MONO_N}^3 at {Ts} A/px with zones planted at "
            f"{[z[2] for z in MONO_ZONES]} A made with numpy in "
            f"{time.perf_counter() - t0:.2f} s")
        run("monores", "resolution_monogenic_signal",
            ["--vol", f("h1.vol"), "--vol2", f("h2.vol"), "--mask",
             f("mask.vol"), "-o", f("mr.vol"), "--sampling_rate", Ts])
        mr = load("mr.vol")
        zq = zone_medians(mr, zones, Ts)
        quality["monores_zones"] = zq
        log("  MonoRes median per zone: " + ", ".join(
            f"{z['median_A']:.3f} A (planted {z['planted_A']}, ratio "
            f"{z['ratio']:.4f})" for z in zq))
        limit(all(abs(z["ratio"] - 1) <= t for z, t in zip(zq,
                                                            MONO_ZONE_TOL)),
              f"phase 9: a zone's median resolution is off its plant by "
              f"more than {MONO_ZONE_TOL}: {zq}")
        prog = run("monotomo", "resolution_monotomo",
                   ["--vol", f("t1.vol"), "--vol2", f("t2.vol"), "--mask",
                    f("tmask.vol"), "-o", f("mt.vol"), "--sampling_rate",
                    Ts])
        mt = load("mt.vol")
        quality["monotomo_median_A"] = prog.median_resolution
        limit(mt.shape == (MONO_TOMO_SLAB, MONO_N, MONO_N)
              and np.isfinite(mt).all() and 2 * Ts <= prog.median_resolution
              <= 30, f"phase 9: monotomo's map {mt.shape}, median "
              f"{prog.median_resolution}")
        spans = {}
        for key, pair in (("iso", ("i1", "i2")), ("aniso", ("a1", "a2"))):
            prog = run(f"fso_{key}", "resolution_fso",
                       ["--half1", f(pair[0] + ".vol"), "--half2",
                        f(pair[1] + ".vol"), "-o", f(f"fso_{key}.xmd"),
                        "--sampling", Ts])
            spans[key] = fso_span(prog.fso)
        quality["fso_span"] = spans
        log(f"  FSO between 0.1 and 0.9 over {spans['iso']:.4f} cycles/px "
            f"for the isotropic pair, {spans['aniso']:.4f} for the "
            "anisotropic one")
        limit(spans["iso"] <= FSO_SPAN_ISO_MAX
              and spans["aniso"] >= FSO_SPAN_ANISO_MIN,
              f"phase 9: FSO spans {spans} (limits iso <= "
              f"{FSO_SPAN_ISO_MAX}, aniso >= {FSO_SPAN_ANISO_MIN})")
        run("localfilter", "resolution_localfilter",
            ["--vol", f("mean.vol"), "--resvol", f("mr.vol"), "-o",
             f("lf.vol"), "--sampling", Ts])
        prog = run("bfactor", "volume_correct_bfactor",
                   ["-i", f("mean.vol"), "-o", f("bf.vol"), "--sampling", Ts,
                    "--auto"])
        quality["bfactor_A2"] = prog.B
        run("structure_factor", "volume_structure_factor",
            ["-i", f("mean.vol"), "-o", f("sf.xmd"), "--sampling", Ts])
        sf = MetaData(f("sf.xmd")).getColumn("logStructureFactor")
        for name in ("lf.vol", "bf.vol"):
            v = load(name)
            limit(v.shape == mean.shape and np.isfinite(v).all(),
                  f"phase 9: {name} of shape {v.shape}, finite "
                  f"{np.isfinite(v).all()}")
        limit(len(sf) == MONO_N // 2 and np.isfinite(sf).all(),
              f"phase 9: {len(sf)} structure-factor shells")
        run("directional", "resolution_directional",
            ["--vol", f("mean.vol"), "--mask", f("mask.vol"), "--oroot",
             f("md"), "--sampling_rate", Ts])
        md = load("md_monores.vol")
        inner, outer = float(md[zones[0]].mean()), \
            float(md[zones[-1]].mean())
        quality["directional"] = {"inner_mean_A": inner,
                                  "outer_mean_A": outer}
        log(f"  resolution_directional: mean resolution {inner:.3f} A in "
            f"the inner zone, {outer:.3f} A in the outer")
        limit(np.isfinite(md).all() and inner < outer,
              f"phase 9: directional inner {inner} vs outer {outer}")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
        shutil.rmtree(root, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - start
    log(f"  phase 9 took {report['phase_s']:.2f} s")
    log("movie " + json.dumps(report))
    limit.check()


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 10: BASELINE config 4's CL2D half - 2-D classification through the
# CLI: CL2D (serial and --mesh dp), its core analysis, ML2D (serial and
# --mesh dp), MLF2D with CTFs, KerDenSOM and angular_accuracy_pca
# ---------------------------------------------------------------------------

CLS_DIRS = 16                 # directions of phase 4's gallery, far apart
CLS_SHIFT = 4.0               # shifts uniform in +-4 px per axis at N=128
# noise sigma over the mean std of the 16 clean class images (SNR 1)
CLS_NOISE = 1.0
CLS_NREF, CLS_NREF0, CLS_ITER = 16, 4, 10
CLS_SOM = (7, 7)
# KerDenSOM: standardised spectra, regularisation 10 -> 1 (at the program's
# 1000 -> 100 the map's code vectors collapse onto each other here)
CLS_SOM_FLAGS = ("--norm", "--reg0", 10, "--regF", 1)
CLS_HARMONICS = 64            # the rotational spectrum's length
CLS_CTF_GROUPS = 4
CLS_MOVED, CLS_MOVE_DEG = 0.05, 15.0   # angular_accuracy_pca's moved rows
ML2D_SHAPE = (1024, 61, 32, 257)       # K4 in ML2D's E-step: B, nr, R, k
# the limits were planned on 2,000 views, the ML programs on 1,000
# (tools/plan_classify.py). Every program takes 4,096 views: two of
# CL2D's 2,048-image match chunks, so that each rank of its mesh run
# matches one. The ML programs keep them too: on 1,000 views MLF2D's
# purity depends on the draw more than on the program (the reference
# read 0.519-0.771 on five 1,000-view draws of this recipe, below the
# 0.54 limit on two; tools/probe_ml_subset.py), while on the same
# draw the port and the reference agree (0.522 each)
CLS_VIEWS = 4096
# limits: twice the shortfall that tools/plan_classify.py read of the
# reference package on the same recipe (2,000 views, the ML programs on
# 1,000; PERF.md §6): CL2D purity 0.6505 and 13 directions won,
# its --mesh dp run's classes those of the serial run for 1.0 of the
# views, ML2D 0.928 / 15, MLF2D 0.771 / 13, the class averages' median
# correlation 0.9919 / 0.8591, the moved rows' AUC 0.99924; KerDenSOM's
# node purity 0.433, held to half (twice its distance to 1 is below 0)
CLS_CL2D_PURITY = 0.30
CLS_CL2D_WON = 10
CLS_MESH_SAME = 1.0           # CL2D mesh run: views in the serial class
CLS_ML2D_PURITY = 0.54
CLS_ML2D_WON = 10
CLS_AVG_CORR = 0.71           # class averages against their clean image
CLS_MESH_REF_TOL, CLS_MESH_FRAC_TOL = 1e-3, 1e-4
CLS_SOM_PURITY = 0.21
CLS_AUC = 0.998


def classify_recipe(n: int, views: int, seed: int):
    """Phase 10's data, drawn with numpy from the seed: the CLS_DIRS
    directions of the 5-degree gallery chosen by farthest-point sampling
    (a direction and its antipode count as one view), each view's
    direction label (views / CLS_DIRS each, in random order), its 2-D
    transform G (content moved by G: x-mirror of half the views, psi
    uniform on [0, 360), shifts uniform in +-CLS_SHIFT * n / N px) and the
    Generator for the noise."""
    from xmipp3_tpu_torch.core.sampling import (Sampling,
                                                directions_from_angles)
    from xmipp3_tpu_torch.ops.geo import alignment_matrices_2d
    angles = Sampling(GALLERY_RATE).angles
    d = directions_from_angles(angles)
    chosen = [0]
    near = np.abs(d @ d[0])
    for _ in range(CLS_DIRS - 1):
        k = int(np.argmin(near))
        chosen.append(k)
        near = np.maximum(near, np.abs(d @ d[k]))
    rng = np.random.default_rng(seed + 10)
    label = rng.permutation(np.repeat(np.arange(CLS_DIRS),
                                      -(-views // CLS_DIRS))[:views])
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-CLS_SHIFT, CLS_SHIFT, (2, views)) * n / N
    mirror = rng.uniform(size=views) < 0.5
    G = alignment_matrices_2d(psi.astype(np.float32), sx.astype(np.float32),
                              sy.astype(np.float32), device="cpu").numpy()
    G = G.astype(np.float64) @ np.where(mirror[:, None, None],
                                        np.diag([-1.0, 1.0, 1.0]), np.eye(3))
    return dict(angles=angles[chosen], label=label, G=G, mirror=mirror,
                rng=rng)


def registration_rows(G, mirror):
    """The registration that undoes each plant, as image_align writes it:
    (psi, shiftX, shiftY) with ops.geo's metadata matrix
    M_x^flip R(-psi) T(s) = G^-1."""
    Minv = np.linalg.inv(G)
    R = np.where(mirror[:, None, None], np.diag([-1.0, 1.0, 1.0]),
                 np.eye(3)) @ Minv                       # R(-psi) T(s)
    psi = np.degrees(np.arctan2(R[:, 1, 0], R[:, 0, 0]))
    s = np.linalg.solve(R[:, :2, :2], R[:, :2, 2:3])[..., 0]
    return psi, s[:, 0], s[:, 1]


def classify_views(n: int, views: int, seed: int, device, batch: int = 1000):
    """(class images (CLS_DIRS, n, n), clean views (V, n, n), noise (V, n,
    n), recipe) as float32 numpy: each class image the analytic projection
    of BLOBS8 (centres scaled by n / N) along its direction, each view that
    projection moved by its G, evaluated on `device` a batch at a time;
    the noise is Gaussian of CLS_NOISE times the class images' mean std,
    drawn with numpy."""
    import torch
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    rec = classify_recipe(n, views, seed)
    A = np.asarray(euler_matrix(rec["angles"][:, 0], rec["angles"][:, 1],
                                np.zeros(CLS_DIRS)), np.float64)
    c = np.array([[cx, cy, cz] for cz, cy, cx, _, _ in BLOBS8]) * n / N
    px, py = A[:, 0] @ c.T, A[:, 1] @ c.T                  # (dirs, blobs)
    s = torch.as_tensor([b[3] for b in BLOBS8], dtype=torch.float64,
                        device=device)
    amp = torch.as_tensor([b[4] * b[3] * np.sqrt(2 * np.pi) for b in BLOBS8],
                          dtype=torch.float64, device=device)
    g = torch.arange(n, dtype=torch.float64, device=device) - n // 2
    y, x = g[:, None], g[None, :]

    def render(Gb, lab):
        Gb = torch.as_tensor(Gb, device=device)
        bx = torch.as_tensor(px[lab], device=device)       # (b, blobs)
        by = torch.as_tensor(py[lab], device=device)
        qx = Gb[:, 0, 0, None] * bx + Gb[:, 0, 1, None] * by + Gb[:, 0, 2, None]
        qy = Gb[:, 1, 0, None] * bx + Gb[:, 1, 1, None] * by + Gb[:, 1, 2, None]
        out = torch.zeros((len(Gb), n, n), dtype=torch.float64, device=device)
        for j in range(len(BLOBS8)):
            out += amp[j] * torch.exp(
                -((x - qx[:, j, None, None]) ** 2
                  + (y - qy[:, j, None, None]) ** 2) / (2 * s[j] ** 2))
        return out.to(torch.float32).cpu().numpy()

    classes = render(np.tile(np.eye(3), (CLS_DIRS, 1, 1)),
                     np.arange(CLS_DIRS))
    clean = np.concatenate([render(rec["G"][lo:lo + batch],
                                   rec["label"][lo:lo + batch])
                            for lo in range(0, views, batch)])
    sigma = CLS_NOISE * float(classes.std(axis=(1, 2)).mean())
    noise = sigma * rec["rng"].standard_normal(clean.shape, dtype=np.float32)
    return classes, clean, noise, rec


def rotational_spectra(imgs, device, batch: int = 2000):
    """Each image's rotational spectrum: the log of the ring power per
    angular harmonic 1..CLS_HARMONICS of its ring FFTs (rings 2..n/2-2 on
    the default polar grid), summed over the rings; psi- and
    mirror-invariant. (V, CLS_HARMONICS) float32 numpy."""
    import torch
    from xmipp3_tpu_torch.ops.polar import cartesian_to_polar, ring_ffts
    n = imgs.shape[-1]
    out = []
    for lo in range(0, len(imgs), batch):
        f = ring_ffts(cartesian_to_polar(torch.as_tensor(
            imgs[lo:lo + batch], device=device), 2, n // 2 - 2))
        p = (f[..., 1:CLS_HARMONICS + 1].abs() ** 2).sum(dim=1)
        out.append(torch.log(p + 1e-12).cpu().numpy())
    return np.concatenate(out).astype(np.float32)


def class_purity(assign, label):
    """(the share of views whose class's majority direction is their own,
    the number of directions that are some class's majority)."""
    assign, label = np.asarray(assign), np.asarray(label)
    right, won = 0, set()
    for k in np.unique(assign):
        lab = label[assign == k]
        vals, counts = np.unique(lab, return_counts=True)
        right += counts.max()
        won.add(int(vals[np.argmax(counts)]))
    return right / len(label), len(won)


def same_classes(a, b):
    """The share of views that two classifications put in the same class,
    each class of `a` paired with one of `b` so that the most views agree
    (class numbers are arbitrary: a split can give them in another
    order)."""
    from scipy.optimize import linear_sum_assignment
    a, b = np.asarray(a), np.asarray(b)
    ka, kb = np.unique(a, return_inverse=True), np.unique(b,
                                                          return_inverse=True)
    overlap = np.zeros((len(ka[0]), len(kb[0])))
    np.add.at(overlap, (ka[1], kb[1]), 1)
    rows, cols = linear_sum_assignment(-overlap)
    return float(overlap[rows, cols].sum() / len(a))


def auc_lower(score, moved):
    """The probability that a moved row scores below an unmoved one (ties
    count half): the AUC of `score` as a detector of the moved rows."""
    score, moved = np.asarray(score, np.float64), np.asarray(moved, bool)
    order = np.argsort(np.concatenate([score[moved], score[~moved]]),
                       kind="mergesort")
    ranks = np.empty(len(order))
    ranks[order] = np.arange(1, len(order) + 1)
    allv = np.concatenate([score[moved], score[~moved]])
    # average ranks over ties
    for v in np.unique(allv):
        tie = allv == v
        if tie.sum() > 1:
            ranks[tie] = ranks[tie].mean()
    m, u = int(moved.sum()), int((~moved).sum())
    r_moved = ranks[:m].sum()
    return 1.0 - (r_moved - m * (m + 1) / 2) / (m * u)


def moved_poses(angles, label, seed: int):
    """(rot, tilt, moved) of each view's direction with CLS_MOVED of the
    rows moved by CLS_MOVE_DEG in rot or in tilt (chosen with numpy)."""
    rng = np.random.default_rng(seed + 11)
    rot = angles[label, 0].copy()
    tilt = angles[label, 1].copy()
    moved = rng.uniform(size=len(label)) < CLS_MOVED
    in_rot = rng.uniform(size=len(label)) < 0.5
    rot[moved & in_rot] += CLS_MOVE_DEG
    tilt[moved & ~in_rot] += CLS_MOVE_DEG
    return rot, tilt, moved


def ml2d_operands(views, classes, device):
    """K4's operands in ML2D's E-step at ML2D_SHAPE: the ring FFTs (61
    rings, 512 angles, k = 257) of the first 1024 views and of the 16 class
    images and their x-mirrors, and the ring weights r / A."""
    import torch
    from xmipp3_tpu_torch.models.ml2d import _ring_spectra, _weights
    from xmipp3_tpu_torch.ops.geo import centered_flip
    B, nr, R, K = ML2D_SHAPE
    n = views.shape[-1]
    cls = torch.as_tensor(classes, device=device)
    fr = _ring_spectra(torch.cat([cls, centered_flip(cls, -1)]), 2, n // 2 - 2)
    fi = _ring_spectra(torch.as_tensor(views[:B], device=device), 2,
                       n // 2 - 2)
    w, _ = _weights(fr, 2, torch.ones(nr, device=device))
    check(fi.shape == (B, nr, K) and fr.shape == (R, nr, K),
          f"ML2D's ring FFTs {tuple(fi.shape)}, {tuple(fr.shape)}")
    return fi, fr, w


def cross_at_ml2d_shape(fi, fr, w):
    """K4 against its plain version at ML2D's shape (odd k, no mirror
    output), timed beside the plain version and one complex einsum."""
    import torch
    from xmipp3_tpu_torch.ops import cross
    B, nr, K = fi.shape
    R = fr.shape[0]
    log(f"phase 10: cross_spectrum at ML2D's shape B={B}, nr={nr}, R={R}, "
        f"k={K}, no mirror")
    got = cross.cross_spectrum(fi, fr, w)
    want = cross.cross_spectrum_plain(fi, fr, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    log(f"  cross_spectrum: max|kernel-plain| = {err:.3e}, / max|plain| = "
        f"{rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL_CROSS,
          f"cross_spectrum at ML2D's shape: kernel disagrees with its plain "
          f"version ({rel:.3e} > {TOL_CROSS})")
    del got, want
    ms = time_ms(lambda: cross.cross_spectrum(fi, fr, w), reps=20)
    plain_ms = time_ms(lambda: cross.cross_spectrum_plain(fi, fr, w),
                       reps=5, warmup=1)
    wi = w[None, :, None]
    library_ms = time_ms(lambda: torch.einsum("brk,Rrk->bRk", fi * wi,
                                              fr.conj()), reps=10)
    nbytes = 8 * (B + R) * nr * K + 4 * nr + 8 * B * R * K
    nops = 8 * B * nr * R * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    log(f"  cross_spectrum: {ms:.4f} ms (plain {plain_ms:.4f} ms, complex "
        f"einsum {library_ms:.4f} ms); bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms)")
    src, replaces = KERNELS["cross_spectrum"]
    return {"name": "cross_spectrum_ml2d", "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": [B, nr, R, K]}


def average_corr(refs, classes, majority, device):
    """Each class average's correlation with its majority direction's clean
    image after the best in-plane alignment (match_to_gallery against that
    one image, mirrors checked)."""
    import torch
    from xmipp3_tpu_torch.ops.match import match_to_gallery
    out = []
    for k, ref in enumerate(refs):
        res = match_to_gallery(torch.as_tensor(classes[majority[k]][None],
                                               device=device),
                               torch.as_tensor(ref[None], device=device),
                               max_shift=8)
        out.append(float(res["corr"][0]))
    return out


def majorities(assign, label, n_cls):
    out = np.zeros(n_cls, int)
    for k in range(n_cls):
        lab = label[assign == k]
        out[k] = np.bincount(lab, minlength=CLS_DIRS).argmax() if len(lab) \
            else 0
    return out


def write_classify_data(root: Path, n: int, views: int, seed: int, device):
    """Phase 10's files in root: views.mrcs/.xmd (image, itemId),
    ctf_views.mrcs/.xmd (the clean views through CLS_CTF_GROUPS planted
    CTFs at CTF_TS, then the same noise; inline ctf* labels), poses.xmd
    (the planted registration, the direction's rot/tilt with CLS_MOVED of
    them moved), spectra.xmd (classificationData: rotational spectra),
    phantom.vol. Returns dict(classes, label, moved, pin, back_corr): pin
    is max |M G - I| of the written registration M, back_corr the least
    correlation of 64 noise-free views registered by their rows with their
    class image."""
    import torch
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops.geo import (apply_md_geometry,
                                          metadata_alignment_matrices)
    f = lambda name: str(root / name)
    classes, clean, noise, rec = classify_views(n, views, seed, device)
    label, G, mirror = rec["label"], rec["G"], rec["mirror"]
    psi, sx, sy = registration_rows(G, mirror)
    M = metadata_alignment_matrices(psi.astype(np.float32),
                                    sx.astype(np.float32),
                                    sy.astype(np.float32), mirror,
                                    device="cpu").numpy().astype(np.float64)
    back = apply_md_geometry(torch.as_tensor(clean[:64], device=device),
                             psi[:64], sx[:64], sy[:64],
                             mirror[:64]).cpu().numpy()
    out = dict(classes=classes, label=label,
               pin=float(np.abs(M @ G - np.eye(3)).max()),
               back_corr=min(real_corr(b, classes[k])
                             for b, k in zip(back, label[:64])))
    save_image(f("views.mrcs"), clean + noise)
    MetaData.fromRows({"image": f"{i + 1}@{f('views.mrcs')}", "itemId": i + 1}
                      for i in range(views)).write(f("views.xmd"))
    save_image(f("phantom.vol"), phantom(n, [
        (cz * n / N, cy * n / N, cx * n / N, s, a)
        for cz, cy, cx, s, a in BLOBS8]))
    rot, tilt, out["moved"] = moved_poses(rec["angles"], label, seed)
    MetaData.fromRows(
        {"image": f"{i + 1}@{f('views.mrcs')}", "itemId": i + 1,
         "angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
         "anglePsi": float(psi[i]), "shiftX": float(sx[i]),
         "shiftY": float(sy[i]), "flip": int(mirror[i])}
        for i in range(views)).write(f("poses.xmd"))
    per = -(-views // CLS_CTF_GROUPS)
    ctf_views = np.empty_like(clean)
    rows = []
    for g, (u, v, az) in enumerate(zip(*ctf_recipe(CLS_CTF_GROUPS))):
        sl = slice(g * per, (g + 1) * per)
        ctf_views[sl] = np.fft.irfft2(np.fft.rfft2(clean[sl]) * plant_ctf(
            n, CTF_TS, u, v, az), s=(n, n)) + noise[sl]
        rows += [{"ctfDefocusU": float(u), "ctfDefocusV": float(v),
                  "ctfDefocusAngle": float(az), "ctfVoltage": CTF_KV,
                  "ctfSphericalAberration": CTF_CS, "ctfQ0": CTF_Q0,
                  "ctfSamplingRate": CTF_TS}
                 for _ in range(len(ctf_views[sl]))]
    save_image(f("ctf_views.mrcs"), ctf_views.astype(np.float32))
    MetaData.fromRows(dict(rows[i], image=f"{i + 1}@{f('ctf_views.mrcs')}",
                           itemId=i + 1)
                      for i in range(views)).write(f("ctf_views.xmd"))
    del ctf_views
    spectra = rotational_spectra(clean + noise, device)
    MetaData.fromRows({"itemId": i + 1, "classificationData": list(v)}
                      for i, v in enumerate(spectra)).write(f("spectra.xmd"))
    return out


def core_quality(cl2d_dir: Path, root: str, label, levels: int):
    """Per level of a CL2D hierarchy written with the rows of views.xmd:
    whether every class block's core is a subset of the block, the share
    of the views in the cores, the classes' and the cores' purity; and the
    stable core's size at the last level (0 without the file)."""
    from xmipp3_tpu_torch.core.star import read_star

    def members(fn):
        """{class block: the views in it} of a level file."""
        return {b.name: set(b.df["itemId"].astype(int) - 1)
                if "itemId" in b.df else set()
                for b in read_star(fn) if b.name.endswith("_images")}

    cores = []
    for lev in range(levels):
        d = cl2d_dir / f"level_{lev:02d}"
        cls = members(str(d / f"{root}_classes.xmd"))
        core_of = members(str(d / f"{root}_classes_core.xmd"))
        blocks = list(cls)
        a_cls, a_core, subset = [], [], True
        for b in blocks:
            core = core_of.get(b, set())
            subset &= core <= cls[b]
            members_b = cls[b]
            a_cls += [(i, b) for i in members_b]
            a_core += [(i, b) for i in core]
        pur = lambda a: class_purity([b for _, b in a],
                                     label[[i for i, _ in a]])[0] \
            if a else 0.0
        cores.append({"level": lev, "classes": len(blocks),
                      "core_share": len(a_core) / len(label),
                      "purity": pur(a_cls), "core_purity": pur(a_core),
                      "subset": subset})
    fs = cl2d_dir / f"level_{levels - 1:02d}" / \
        f"{root}_classes_stable_core.xmd"
    stable = sum(len(v) for v in members(str(fs)).values()) \
        if fs.is_file() else 0
    return cores, stable


def classify_2d(seed, root: Path):
    """Phase 10 in root: BASELINE config 4's CL2D half at N=128. Returns
    K4's entry at ML2D's shape and the K4 launches of the serial ML2D
    run."""
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.core.metadata import MetaData
    root.mkdir(parents=True)
    f = lambda name: str(root / name)
    report, quality = {}, {}
    limit = Limits(10)

    run = partial(run_program, 10, report)

    def mesh_run(label, name, args):
        for r, rep in enumerate(run_mesh(report, root, label, name, args)):
            check(rep["launches"]["cross_spectrum"] > 0, f"phase 10 {label}: "
                  f"rank {r} never launched cross_spectrum")

    def column(fn, key, count=CLS_VIEWS):
        md = MetaData(fn)
        rows = sorted((md.getRow(i) for i in md), key=lambda r: r["itemId"])
        check(len(rows) == count, f"phase 10 {fn}: {len(rows)} rows")
        return np.array([r[key] for r in rows])

    def refs_of(fn, count):
        refs = Image.read_stack(fn)
        check(refs.shape == (count, N, N) and np.isfinite(refs).all(),
              f"phase 10 {fn}: references of shape {refs.shape}, finite "
              f"{np.isfinite(refs).all()}")
        return refs

    start = time.perf_counter()
    t0 = time.perf_counter()
    data = write_classify_data(root, N, CLS_VIEWS, seed, DEVICE)
    label, moved, classes = data["label"], data["moved"], data["classes"]
    log(f"phase 10: {CLS_VIEWS} views of {CLS_DIRS} far-apart directions of "
        f"BLOBS8 at N={N} (psi, +-{CLS_SHIFT} px, half mirrored, noise "
        f"{CLS_NOISE} sigma) made and written in "
        f"{time.perf_counter() - t0:.2f} s (views, CTF views, poses with "
        f"{int(moved.sum())} rows moved by {CLS_MOVE_DEG} deg, "
        f"{CLS_HARMONICS}-harmonic rotational spectra); the written pose "
        f"undoes the plant to {data['pin']:.2e}, and maps noise-free views "
        f"onto their class image (corr >= {data['back_corr']:.4f})")
    check(data["pin"] <= 1e-4 and data["back_corr"] >= 0.99, "phase 10: "
          f"the written registration does not undo the plant "
          f"({data['pin']:.2e}, corr {data['back_corr']:.4f})")
    views = Image.read_stack(f("views.mrcs"))[:ML2D_SHAPE[0]]

    kernel = cross_at_ml2d_shape(*ml2d_operands(views, classes, DEVICE))
    k4_ml2d = 0
    timing.enable_timing(True)
    try:
        # CL2D, serial and over 2 ranks
        cl2d_args = ["-i", f("views.xmd"), "--odir", f("cl2d"), "--oroot",
                     "cl", "--nref", CLS_NREF, "--nref0", CLS_NREF0, "--iter",
                     CLS_ITER]
        (root / "cl2d").mkdir()
        run("cl2d", "classify_CL2D", cl2d_args)
        check(report["cl2d"]["launches"].get("cross_spectrum", 0) > 0,
              "phase 10: classify_CL2D never launched cross_spectrum")
        refs_of(f("cl2d/cl_references.stk"), CLS_NREF)
        assign = column(f("cl2d/cl_images.xmd"), "ref") - 1
        pur, won = class_purity(assign, label)
        quality["cl2d"] = {"purity": pur, "directions_won": won}
        log(f"  CL2D: purity {pur:.4f}, {won} of {CLS_DIRS} directions won")
        limit(pur >= CLS_CL2D_PURITY and won >= CLS_CL2D_WON,
              f"phase 10 CL2D: purity {pur:.4f} (limit {CLS_CL2D_PURITY}), "
              f"{won} directions won (limit {CLS_CL2D_WON})")
        (root / "cl2d_mesh").mkdir()
        mesh_run("cl2d_mesh", "classify_CL2D",
                 [a if a != f("cl2d") else f("cl2d_mesh") for a in cl2d_args])
        mesh_assign = column(f("cl2d_mesh/cl_images.xmd"), "ref") - 1
        same = same_classes(mesh_assign, assign)
        m_pur, m_won = class_purity(mesh_assign, label)
        quality["cl2d"].update(mesh_same_class=same, mesh_purity=m_pur,
                               mesh_directions_won=m_won)
        log(f"  CL2D --mesh dp: {same:.4f} of the views in the serial "
            f"run's class (classes paired); purity {m_pur:.4f}, {m_won} "
            "directions won")
        limit(same >= CLS_MESH_SAME and m_pur >= CLS_CL2D_PURITY,
              f"phase 10 CL2D mesh: {same:.4f} of the views keep the "
              f"serial class (limit {CLS_MESH_SAME}), purity {m_pur:.4f}")

        # the core analysis of CL2D's hierarchy
        run("core", "classify_CL2D_core_analysis",
            ["--dir", f("cl2d"), "--root", "cl", "--computeCore", 3, 2])
        run("stable_core", "classify_CL2D_core_analysis",
            ["--dir", f("cl2d"), "--root", "cl", "--computeStableCore", 1])
        cores, stable = core_quality(root / "cl2d", "cl", label, 3)
        for c in cores:
            limit(c["subset"] and c["core_purity"] >= c["purity"],
                  f"phase 10 core of level {c['level']}: subset "
                  f"{c['subset']}, purity {c['core_purity']:.4f} against "
                  f"the classes' {c['purity']:.4f}")
        quality["core"] = {"levels": cores, "stable_core_views": stable}
        log("  cores: " + "; ".join(
            f"level {c['level']} ({c['classes']} classes) keeps "
            f"{c['core_share']:.4f}, purity {c['purity']:.4f} -> "
            f"{c['core_purity']:.4f}" for c in cores)
            + f"; stable core of level 2: {stable} views")
        limit(stable > 0, "phase 10: the stable core of level 2 is empty")

        # ML2D and MLF2D, serial and ML2D over 2 ranks
        for lab, name, inp in (("ml2d", "ml_align2d", "views.xmd"),
                               ("mlf2d", "mlf_align2d", "ctf_views.xmd")):
            extra = ["--sampling_rate", CTF_TS] if name == "mlf_align2d" \
                else []
            args = ["-i", f(inp), "--nref", CLS_NREF, "--mirror", "--iter",
                    CLS_ITER, "--oroot", f(lab), *extra]
            prog = run(lab, name, args)
            k4 = report[lab]["launches"].get("cross_spectrum", 0)
            check(k4 > 0, f"phase 10: {name} never launched cross_spectrum")
            if lab == "ml2d":
                k4_ml2d = k4
            res = prog.result
            ll = np.asarray(res["loglike"])
            dips = int((np.diff(ll) < -1e-3 * np.abs(ll[:-1])).sum())
            refs = refs_of(f(f"{lab}_references.stk"), CLS_NREF)
            assign = column(f(f"{lab}_images.xmd"), "ref") - 1
            pur, won = class_purity(assign, label)
            corr = average_corr(refs, classes,
                                majorities(assign, label, CLS_NREF), DEVICE)
            q = quality[lab] = {"loglike": ll.tolist(), "dips": dips,
                                "purity": pur, "directions_won": won,
                                "avg_corr_min": min(corr),
                                "avg_corr_median": float(np.median(corr)),
                                "iterations": len(ll)}
            log(f"  {name}: LL {ll[0]:.2f} -> {ll[-1]:.2f} in {len(ll)} "
                f"iterations ({dips} dips), purity {pur:.4f}, {won} "
                f"directions won, class averages vs their clean image: "
                f"median {q['avg_corr_median']:.4f}, min {min(corr):.4f}")
            limit(ll[-1] > ll[0] and dips == 0, f"phase 10 {name}: LL "
                  f"{ll.round(3).tolist()}")
            limit(pur >= CLS_ML2D_PURITY and won >= CLS_ML2D_WON,
                  f"phase 10 {name}: purity {pur:.4f} (limit "
                  f"{CLS_ML2D_PURITY}), {won} directions won (limit "
                  f"{CLS_ML2D_WON})")
            limit(float(np.median(corr)) >= CLS_AVG_CORR, f"phase 10 {name}: "
                  f"median class-average correlation {np.median(corr):.4f} "
                  f"(limit {CLS_AVG_CORR})")
            if lab == "ml2d":
                mesh_run("ml2d_mesh", name,
                         [a if a != f(lab) else f("ml2d_mesh")
                          for a in args])
                mr = refs_of(f("ml2d_mesh_references.stk"), CLS_NREF)
                ref_err = max_rel(mr, refs)
                fw = [MetaData(f(r + "_classes.xmd")).getColumn("weight")
                      for r in ("ml2d", "ml2d_mesh")]
                frac_err = float(np.abs(fw[0] - fw[1]).max())
                q.update(mesh_ref_err=ref_err, mesh_frac_err=frac_err)
                log(f"  ml_align2d --mesh dp: references within "
                    f"{ref_err:.2e} of the max, fractions within "
                    f"{frac_err:.2e} of the serial run's")
                limit(ref_err <= CLS_MESH_REF_TOL and
                      frac_err <= CLS_MESH_FRAC_TOL, f"phase 10 ML2D mesh: "
                      f"references {ref_err:.2e}, fractions {frac_err:.2e}")

        # KerDenSOM on the rotational spectra
        prog = run("kerdensom", "classify_kerdensom",
                   ["-i", f("spectra.xmd"), "--oroot", f("som"), "--xdim",
                    CLS_SOM[1], "--ydim", CLS_SOM[0], *CLS_SOM_FLAGS])
        code = np.load(f("som_codebook.npy"))
        check(code.shape == (CLS_SOM[0] * CLS_SOM[1], CLS_HARMONICS)
              and np.isfinite(code).all(), f"phase 10: code book of shape "
              f"{code.shape}")
        pur, won = class_purity(column(f("som_images.xmd"), "ref"), label)
        quality["kerdensom"] = {"node_purity": pur, "directions_won": won}
        log(f"  KerDenSOM {CLS_SOM[0]} x {CLS_SOM[1]}: node purity "
            f"{pur:.4f}, {won} directions won")
        limit(pur >= CLS_SOM_PURITY, f"phase 10 KerDenSOM: node purity "
              f"{pur:.4f} (limit {CLS_SOM_PURITY})")

        # angular_accuracy_pca on the planted poses, 5 % moved
        run("accuracy_pca", "angular_accuracy_pca",
            ["-i", f("poses.xmd"), "--ref", f("phantom.vol"), "-o",
             f("accuracy.xmd")])
        score = column(f("accuracy.xmd"), "scoreByPcaResidual")
        check(np.isfinite(score).all(), "phase 10: scores not finite")
        auc = auc_lower(score, moved)
        quality["accuracy_pca"] = {"auc": auc,
                                   "moved_median": float(np.median(
                                       score[moved])),
                                   "kept_median": float(np.median(
                                       score[~moved]))}
        log(f"  angular_accuracy_pca: AUC {auc:.4f} of the score against "
            f"the {int(moved.sum())} moved rows (medians "
            f"{np.median(score[moved]):.4f} moved, "
            f"{np.median(score[~moved]):.4f} kept)")
        limit(auc >= CLS_AUC, f"phase 10 angular_accuracy_pca: AUC {auc:.4f} "
              f"(limit {CLS_AUC})")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["phase_s"] = time.perf_counter() - start
    log(f"  phase 10 took {report['phase_s']:.2f} s")
    log("classify " + json.dumps(report))
    limit.check()
    kernel["launches"] = k4_ml2d
    return kernel


# ---------------------------------------------------------------------------
# phase 11: the image and metadata utilities, ART, SIRT and WBP,
# align_significant and reconstruct_significant through the CLI
# ---------------------------------------------------------------------------

RM_ART_BLOCK, RM_ART_ITERS = 1000, 2   # pSART: 10 blocks a pass, 20 passes
RM_SIRT_ITERS = 3
RM_FILSAM = 5.0                        # the arbitrary filter's sampling
RM_WBP_DIAMETER = 0.75                 # --diameter as a share of N
RM_SIG_VIEWS = 256                     # "class averages" of the 8-blob map
RM_SIG_NOISE = 0.05                    # their noise, a share of their sigma
RM_SIG_SHIFT = 1.0                     # their shifts, uniform in +-1 px
RM_SIG_LOWPASS = 0.125                 # the start volume: a quarter of Nyquist
RM_SIG_RATE, RM_SIG_ITERS, RM_SIG_MAX_SHIFT = 5.0, 3, 4
RM_ASIG_ANG, RM_ASIG_MAX_SHIFT = 10.0, 4
RM_NOISE_SIGMA = 0.5                   # transform_add_noise's gaussian
RM_PAD = 16                            # transform_window: N + 32 and back
RM_NOISE_VIEWS = 2048                  # the noise held against numpy's draws
# the image programs' views: their checks against numpy hold at any count
RM_IMG_VIEWS = 2000
RM_TOL = 1e-4          # resize, noise, phases' amplitudes, the downsample
RM_STATS_TOL = 1e-5    # image_statistics against float64 numpy
RM_ROTATE_DEG = 1e-3   # angular_rotate and its inverse
RM_MESH_TOL = 1e-5     # align_significant --mesh dp weights against serial
RM_KB_CHUNK = 1 << 22  # samples a part of K3's plain version at WBP's launch
# Map-quality limits: twice the shortfall from a correlation of 1 that
# tools/plan_reconstruct_misc.py read of the reference package at N=64
# (ART and SIRT on 2,000 views: 0.99992, 0.9999976; WBP and the ramp on
# 500: 0.8758, 0.8807; reconstruct_significant 0.9104)
RM_ART_CORR = 0.99983
RM_SIRT_CORR = 0.999995
RM_WBP_CORR = 0.7516
RM_WBP_RAMP_CORR = 0.7614
RM_SIG_CORR = 0.8208


def scaled_blobs(blobs, n: int):
    """Blobs made for N=128 with their centres scaled to n (widths kept,
    as the 48-voxel originals were scaled to 128)."""
    k = n / 128
    return [(cz * k, cy * k, cx * k, s, a) for cz, cy, cx, s, a in blobs]


def lowpass_volume(vol, cutoff: float):
    """vol with every frequency above `cutoff` (cycles/px) removed (numpy
    rfftn, float64)."""
    n = vol.shape[-1]
    fz = np.fft.fftfreq(n)[:, None, None]
    fy = np.fft.fftfreq(n)[None, :, None]
    fx = np.fft.rfftfreq(n)[None, None, :]
    keep = fz * fz + fy * fy + fx * fx <= cutoff * cutoff
    return np.fft.irfftn(np.fft.rfftn(vol) * keep, s=vol.shape).astype(
        np.float32)


def significance_data(root: Path, n: int, views: int, seed: int, device):
    """reconstruct_significant's input: `views` projections of the 8-blob
    phantom at uniform directions, psi, shifts of +-RM_SIG_SHIFT px and
    noise of RM_SIG_NOISE sigma (sig.mrcs, sig.xmd), and the phantom
    low-passed to a quarter of Nyquist (init.vol); numpy's draws from the
    seed, the projections on `device`. Returns the phantom."""
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    blobs = scaled_blobs(BLOBS8, n)
    rng = np.random.default_rng(seed + 11)
    rot = rng.uniform(0, 360, views)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, views)))
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-RM_SIG_SHIFT, RM_SIG_SHIFT, (2, views))
    clean = projections(n, rot, tilt, psi, sx, sy, blobs, device=device)
    save_image(str(root / "sig.mrcs"), clean + (RM_SIG_NOISE * clean.std())
               * rng.standard_normal(clean.shape, dtype=np.float32))
    MetaData.fromRows({"image": f"{i + 1}@{root / 'sig.mrcs'}",
                       "itemId": i + 1} for i in range(views)).write(
                           str(root / "sig.xmd"))
    ref = phantom(n, blobs)
    save_image(str(root / "init.vol"), lowpass_volume(ref, RM_SIG_LOWPASS))
    return ref


def non_increasing(hist) -> bool:
    h = np.asarray(hist, np.float64)
    return bool(len(h) > 0 and (np.diff(h) <= 1e-6 * h[0]).all())


def fourier_crop_f64(imgs, oh: int, ow: int):
    """Band-limited resize of a stack by a float64 Fourier crop (the
    reference's recipe, ops/resize.py), written out with torch's FFTs on
    DEVICE; a float64 tensor."""
    import torch
    x = torch.as_tensor(imgs, device=DEVICE).to(torch.float64)
    H, W = x.shape[-2:]
    dims = (-2, -1)
    spec = torch.fft.fftshift(torch.fft.fft2(x), dim=dims)
    y0, x0 = H // 2 - oh // 2, W // 2 - ow // 2
    crop = spec[..., y0:y0 + oh, x0:x0 + ow]
    out = torch.fft.ifft2(torch.fft.ifftshift(crop, dim=dims)).real
    return out * (oh * ow) / (H * W)


def grid_at_views(name, interp, rot, tilt, psi, seed, chunk=None,
                  reps=20, max_freq=0.5, phase=11, n=N, p=P):
    """K2 (interp "tri") or K3 ("kb") against its plain version at the
    sample count of one launch on a phase's path: the slice coordinates of
    the given poses at n, p (N, P by default) within max_freq in one
    stream, and three value streams. With
    `chunk` set, the plain version and the bound's tap count run over
    parts of `chunk` samples (the whole tap expansion would not fit on the
    card), and no single library call exists to time. `reps`: the
    kernel's timed launches."""
    import torch
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.ops import scatter_kb, scatter_tri
    from xmipp3_tpu_torch.ops.reconstruct import (BLOB_ALPHA, BLOB_ORDER,
                                                  BLOB_RADIUS,
                                                  _slice_tap_coords)
    from xmipp3_tpu_torch.ops.scatter import scatter_add_3ch_plain
    mats = torch.as_tensor(euler_matrix(rot, tilt, psi), dtype=torch.float32,
                           device=DEVICE)
    zi, yi, xi = (a.reshape(-1).contiguous()
                  for a in _slice_tap_coords(mats, n, p, max_freq))
    del mats
    M = zi.numel()
    rng = np.random.default_rng(seed + 12)
    vals = np.stack([rng.standard_normal(M), rng.standard_normal(M),
                     rng.uniform(0.5, 1.5, M)]).astype(np.float32)
    samples = (zi, yi, xi, *(torch.as_tensor(v, device=DEVICE)
                             for v in vals))
    del vals
    log(f"phase {phase}: {name} at {len(rot)} views: M = {M} samples")
    if interp == "tri":
        # per sample floor, fractions and 1-f (9); per live corner the
        # weight (2), three products and three adds (6)
        kernel = lambda *c: scatter_tri.tri_scatter(*c, *samples, P=p)
        expand = lambda part: scatter_tri.tri_expand(*part, p)
        costs = (24, 8, 9)
    else:
        # per sample floor and fractions (6); per live tap the distance
        # (8), the degree-7 Horner polynomial (14), three products and
        # three adds (6)
        kb = dict(P=p, radius=BLOB_RADIUS, alpha=BLOB_ALPHA,
                  order=BLOB_ORDER)
        kernel = lambda *c: scatter_kb.kb_scatter_3ch(*c, *samples, **kb)
        expand = lambda part: scatter_kb.kb_expand(*part, **kb)
        costs = (24, 28, 6)
    if chunk is None:
        taps = expand(samples)
        got = compare(
            name, kernel, lambda *c: scatter_add_3ch_plain(*c, *expand(
                samples)), taps, *costs, M,
            library=lambda *c: [a.index_add_(0, taps[0], u)
                                for a, u in zip(c, taps[1:])],
            size=p ** 3, kernel_reps=reps)
        del taps
    else:
        parts = lambda: (expand(tuple(a[s:s + chunk] for a in samples))
                         for s in range(0, M, chunk))
        got = compare(
            name, kernel, lambda *c: [scatter_add_3ch_plain(*c, *t)
                                      for t in parts()],
            parts, *costs, M, size=p ** 3, kernel_reps=reps, plain_reps=1)
        got["plain_chunk_samples"] = chunk
    got["views"] = len(rot)
    del samples
    torch.cuda.empty_cache()
    return got


def utilities_and_reconstruction(seed, root: Path, e2e: Path, cycle: Path,
                                 poses):
    """Phase 11 in root, on phase 3's true-pose views (e2e) and phase 4's
    noisy views, assignments and gallery (cycle, with their true poses).
    Returns K2's entry at a pSART block and the K2 launches of the pSART
    run."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    root.mkdir(parents=True)
    f = lambda name: str(root / name)
    report, quality = {}, {}
    limit = Limits(11)
    run = partial(run_program, 11, report)

    def stack(name):
        return Image.read_stack(f(name))

    def drop(*names):
        for name in names:
            Path(f(name)).unlink()

    parsed = {}

    def column(fn, key):
        if fn not in parsed:
            parsed[fn] = md_rows(fn)
        return np.array([r[key] for r in parsed[fn]])

    views_md = cycle / "views.xmd"
    start = time.perf_counter()
    t0 = time.perf_counter()
    # the image programs take the first RM_IMG_VIEWS of phase 4's views;
    # the metadata programs and align_significant all V rows and views
    data = Image.read_stack(str(cycle / "views.mrcs"))
    V = len(data)
    data = data[:RM_IMG_VIEWS]
    Vi = len(data)
    views_stk = root / "img_views.mrcs"
    save_image(str(views_stk), data)
    sig_ref = significance_data(root, N, RM_SIG_VIEWS, seed, DEVICE)
    log(f"phase 11: the first {Vi} of phase 4's {V} views read and "
        f"rewritten ({data.nbytes / 1e6:.0f} MB) and {RM_SIG_VIEWS} views "
        f"of the 8-blob phantom made in {time.perf_counter() - t0:.2f} s")
    timing.enable_timing(True)
    try:
        # (a) the image programs on phase 4's views
        big, small = N + 2 * RM_PAD, N // 2
        run("window_pad", "transform_window",
            ["-i", views_stk, "-o", f("wide.mrcs"), "--size", big])
        wide = stack("wide.mrcs")
        inner = wide[:, RM_PAD:RM_PAD + N, RM_PAD:RM_PAD + N].copy()
        wide[:, RM_PAD:RM_PAD + N, RM_PAD:RM_PAD + N] = 0.0
        exact = {"window_pad": wide.shape == (Vi, big, big)
                 and bool(np.array_equal(inner, data)) and not wide.any()}
        del wide, inner
        run("window_back", "transform_window",
            ["-i", f("wide.mrcs"), "-o", f("back.mrcs"), "--size", N])
        exact["window_back"] = bool(np.array_equal(stack("back.mrcs"), data))
        drop("wide.mrcs", "back.mrcs")
        run("resize", "image_resize",
            ["-i", views_stk, "-o", f("half.mrcs"), "--fourier", "--dim",
             small])
        resize_err = max_rel(stack("half.mrcs"),
                             fourier_crop_f64(data, small, small))
        drop("half.mrcs")
        run("convert_stk", "image_convert",
            ["-i", views_stk, "-o", f("v.stk")])
        run("convert_back", "image_convert",
            ["-i", f("v.stk"), "-o", f("back.mrcs")])
        exact["convert_round_trip"] = bool(
            np.array_equal(stack("back.mrcs"), data))
        drop("v.stk", "back.mrcs")
        run("operate_plus", "image_operate",
            ["-i", views_stk, "-o", f("plus.mrcs"), "--plus", 1.5])
        run("operate_mult", "image_operate",
            ["-i", f("plus.mrcs"), "-o", f("mult.mrcs"), "--mult", 2])
        exact["operate"] = bool(np.array_equal(
            stack("mult.mrcs"), (data + np.float32(1.5)) * np.float32(2)))
        drop("plus.mrcs", "mult.mrcs")
        run("add_noise", "transform_add_noise",
            ["-i", views_stk, "-o", f("noise.mrcs"), "--type", "gaussian",
             RM_NOISE_SIGMA, 0, "--seed", 0])
        got = stack("noise.mrcs")
        # the first 8 of the program's 256-view batches, drawn from the
        # same Generator in the same order
        rng = np.random.default_rng(0)
        noise_err = 0.0
        for s in range(0, min(Vi, RM_NOISE_VIEWS), 256):
            want = data[s:s + 256] + rng.normal(
                0.0, RM_NOISE_SIGMA, data[s:s + 256].shape).astype(
                    np.float32)
            noise_err = max(noise_err, float(np.abs(got[s:s + 256]
                                                    - want).max()))
        noise_err /= float(np.abs(data).max())
        drop("noise.mrcs")
        run("threshold", "transform_threshold",
            ["-i", views_stk, "-o", f("thr.mrcs"), "--select", "below", 0,
             "--substitute", "value", 0])
        exact["threshold"] = bool(np.array_equal(
            stack("thr.mrcs"), np.where(data < 0, np.float32(0), data)))
        drop("thr.mrcs")
        run("mirror", "transform_mirror",
            ["-i", views_stk, "-o", f("mir.mrcs"), "--flipX"])
        exact["mirror"] = bool(np.array_equal(stack("mir.mrcs"),
                                              data[..., ::-1]))
        drop("mir.mrcs")
        run("randomize_phases", "transform_randomize_phases",
            ["-i", views_stk, "-o", f("rph.mrcs"), "--freq", 0.25, "--seed",
             0])
        fy = np.fft.fftfreq(N)[:, None]
        fx = np.fft.rfftfreq(N)[None, :]
        low = torch.as_tensor(np.sqrt(fy * fy + fx * fx) <= 0.25,
                              device=DEVICE)
        a, b = (torch.fft.rfft2(torch.as_tensor(x, device=DEVICE).to(
            torch.float64)) for x in (stack("rph.mrcs"), data))
        top = float(b.abs().max())
        amp_err = float((a.abs() - b.abs()).abs().max()) / top
        low_err = float((a - b).abs()[:, low].max()) / top
        del a, b
        drop("rph.mrcs")
        run("statistics", "image_statistics",
            ["-i", views_stk, "-o", f("stats.xmd")])
        flat = torch.as_tensor(data, device=DEVICE).reshape(Vi, -1).to(
            torch.float64)
        stats_err = max(max_rel(column(f("stats.xmd"), k), want)
                        for k, want in (("min", flat.amin(1)),
                                        ("max", flat.amax(1)),
                                        ("avg", flat.mean(1)),
                                        ("stddev", flat.std(1, correction=0))))
        del flat
        run("histogram", "image_histogram",
            ["-i", views_stk, "-o", f("hist.xmd"), "--steps", 100])
        counts, _ = np.histogram(data, bins=100, range=(float(data.min()),
                                                        float(data.max())))
        exact["histogram"] = bool(np.array_equal(
            column(f("hist.xmd"), "count"), counts))
        run("header", "image_header", ["-i", views_stk])
        mic = est_plant(EST_SIZE, EST_TS, *EST_A, np.random.default_rng(seed))
        save_image(f("mic.mrc"), mic)
        run("downsample", "transform_downsample",
            ["-i", f("mic.mrc"), "-o", f("mic2.mrc"), "--step", 2])
        down_err = max_rel(np.squeeze(Image(f("mic2.mrc")).data),
                           fourier_crop_f64(mic, EST_SIZE // 2,
                                            EST_SIZE // 2))
        drop("mic.mrc", "mic2.mrc")
        del mic, got
        quality["images"] = {"exact": exact, "resize_err": resize_err,
                             "noise_err": noise_err, "phase_amp_err": amp_err,
                             "phase_low_band_err": low_err,
                             "stats_err": stats_err, "downsample_err": down_err}
        log(f"  image programs: exact {exact}; resize {resize_err:.2e}, noise "
            f"{noise_err:.2e}, randomised phases' amplitudes {amp_err:.2e} "
            f"(kept band {low_err:.2e}), statistics {stats_err:.2e}, "
            f"downsample {down_err:.2e}")
        limit(all(exact.values()), f"phase 11: not exact: {exact}")
        limit(max(resize_err, noise_err, amp_err, low_err, down_err)
              <= RM_TOL, f"phase 11: resize {resize_err:.2e}, noise "
              f"{noise_err:.2e}, phases {amp_err:.2e} / {low_err:.2e}, "
              f"downsample {down_err:.2e} (limit {RM_TOL})")
        limit(stats_err <= RM_STATS_TOL, f"phase 11: statistics "
              f"{stats_err:.2e} (limit {RM_STATS_TOL})")

        # (a) the metadata programs on phase 4's 10,000 assignment rows
        run("md_sort_id", "metadata_utilities",
            ["-i", cycle / "assigned.xmd", "-o", f("assigned.xmd"),
             "--operate", "sort", "itemId"])
        md_in = f("assigned.xmd")
        ids = column(md_in, "itemId").astype(int)
        cc = column(md_in, "maxCC")
        run("md_sort_cc", "metadata_utilities",
            ["-i", md_in, "-o", f("by_cc.xmd"), "--operate", "sort", "maxCC",
             "desc"])
        s_cc = column(f("by_cc.xmd"), "maxCC")
        md_ok = {"sort": bool((np.diff(s_cc) <= 0).all() and np.array_equal(
            np.sort(column(f("by_cc.xmd"), "itemId")), np.sort(ids)))}
        run("md_query", "metadata_utilities",
            ["-i", md_in, "-o", f("query.xmd"), "--query", "select",
             "maxCC > 0.5"])
        md_ok["query"] = bool(np.array_equal(
            column(f("query.xmd"), "itemId"), ids[cc > 0.5]))
        run("md_union", "metadata_utilities",
            ["-i", md_in, "-o", f("union.xmd"), "--set", "union", md_in,
             "image"])
        md_ok["union"] = MetaData(f("union.xmd")).size() == V
        run("md_fill", "metadata_utilities",
            ["-i", md_in, "-o", f("filled.xmd"), "--fill", "ctfDefocusU",
             "lineal", 10000, 1])
        md_ok["fill"] = bool(np.array_equal(
            column(f("filled.xmd"), "ctfDefocusU"), 10000.0 + np.arange(V)))
        (root / "split").mkdir()
        run("md_split", "metadata_split",
            ["-i", md_in, "-n", 4, "--oroot", f("split/part")])
        parts = sorted((root / "split").iterdir())
        md_ok["split"] = len(parts) == 4 and np.array_equal(
            np.sort(np.concatenate([column(p, "itemId") for p in parts])),
            np.sort(ids))
        run("md_histogram", "metadata_histogram",
            ["-i", md_in, "--col", "maxCC", "--steps", 50, "-o", f("mh.xmd")])
        md_ok["histogram"] = bool(np.array_equal(
            column(f("mh.xmd"), "count"),
            np.histogram(cc, bins=50, range=(cc.min(), cc.max()))[0]))
        # angular_distance between the truth and the assignments
        order = ids - 1
        MetaData.fromRows(
            {"itemId": int(i + 1), "angleRot": float(poses["rot"][i]),
             "angleTilt": float(poses["tilt"][i]),
             "anglePsi": float(poses["psi"][i]),
             "shiftX": float(poses["sx"][i]),
             "shiftY": float(poses["sy"][i])} for i in order).write(
                 f("truth.xmd"))
        run("angular_distance", "angular_distance",
            ["--ang1", f("truth.xmd"), "--ang2", md_in, "--oroot",
             f("angdist"), "--check_mirrors"])
        dist = column(f("angdist.xmd"), "angleDiff")
        rows = md_rows(md_in)
        d_true = directions_from_angles(np.stack(
            [poses["rot"][order], poses["tilt"][order]], 1))
        ang4 = np.degrees(np.arccos(np.clip(
            (d_true * effective_directions(rows)).sum(1), -1, 1)))
        within4 = float((ang4 <= 1.5 * GALLERY_RATE).mean())
        within_ad = float((dist <= 1.5 * GALLERY_RATE).mean())
        dist_err = float(np.abs(dist - np.minimum(ang4, 180 - ang4)).max())
        # both read directions of float32 Euler matrices: near 0 degrees
        # their 1e-7 noise moves an angle by up to 0.01 degrees
        md_ok["angular_distance"] = dist_err <= 1e-2 and within_ad >= within4
        # angular_rotate and its inverse
        run("angular_rotate", "angular_rotate",
            ["-i", md_in, "-o", f("rot.xmd"), "--rotate", 10, 20, 30])
        run("angular_rotate_back", "angular_rotate",
            ["-i", f("rot.xmd"), "-o", f("back.xmd"), "--rotate", -30, -20,
             -10])
        mats = [np.asarray(euler_matrix(*[column(fn, k) for k in (
            "angleRot", "angleTilt", "anglePsi")]), np.float64)
            for fn in (md_in, f("back.xmd"))]
        rel = np.einsum("nji,njk->nik", *mats) - np.eye(3)
        rot_err = float(np.degrees(np.linalg.norm(rel, axis=(1, 2))
                                   / np.sqrt(2)).max())
        # the EMX round trip
        run("emx_export", "metadata_convert_emx",
            ["-i", f("filled.xmd"), "-o", f("x.emx")])
        run("emx_import", "metadata_convert_emx",
            ["-i", f("x.emx"), "-o", f("emx.xmd")])
        back = md_rows(f("emx.xmd"))
        name = lambda v: (lambda a: (int(a[0]), a[1]))(str(v).split("@", 1))
        md_ok["emx"] = bool(
            [name(r["image"]) for r in back]
            == [name(r["image"]) for r in rows]
            and np.array_equal([r["ctfDefocusU"] for r in back],
                               10000.0 + np.arange(V)))
        quality["metadata"] = {"ok": md_ok, "within_7.5_phase4": within4,
                               "within_7.5_angular_distance": within_ad,
                               "angular_distance_err_deg": dist_err,
                               "rotate_inverse_err_deg": rot_err}
        log(f"  metadata programs: {md_ok}; views within "
            f"{1.5 * GALLERY_RATE} deg: phase 4 {within4:.4f}, "
            f"angular_distance {within_ad:.4f} (per row within "
            f"{dist_err:.2e} deg of the mirror-folded phase-4 angle); "
            f"angular_rotate and its inverse within {rot_err:.2e} deg")
        limit(all(md_ok.values()), f"phase 11: metadata {md_ok}")
        limit(rot_err <= RM_ROTATE_DEG, f"phase 11: angular_rotate and its "
              f"inverse differ by {rot_err:.2e} deg")

        # (b) ART, SIRT and WBP on phase 3's true-pose views
        rec_md = e2e / "phantom.xmd"
        ref = phantom(N)
        md3 = MetaData(str(rec_md))
        poses3 = [np.asarray(md3.getColumn(k), np.float32)
                  for k in ("angleRot", "angleTilt", "anglePsi")]
        # K2 at a pSART block and at a SIRT pass (every view in one launch),
        # K3 at WBP's one launch of every view
        kernels = [
            grid_at_views("tri_scatter_art_block", "tri",
                          *(a[:RM_ART_BLOCK] for a in poses3), seed),
            grid_at_views("tri_scatter_sirt_pass", "tri", *poses3, seed,
                          reps=5),
            grid_at_views("kb_scatter_3ch_wbp", "kb", *poses3, seed,
                          chunk=RM_KB_CHUNK, reps=3)]
        recs = {}
        for label, args, limit_corr, kname, launches in (
                ("art_psart", ["--parallel_mode", "pSART", "--block_size",
                               RM_ART_BLOCK, "-n", RM_ART_ITERS],
                 RM_ART_CORR, "tri_scatter",
                 RM_ART_ITERS * -(-VIEWS // RM_ART_BLOCK)),
                ("art_sirt", ["--parallel_mode", "SIRT", "-n", RM_SIRT_ITERS,
                              "--POCS_positivity"], RM_SIRT_CORR,
                 "tri_scatter", RM_SIRT_ITERS),
                ("wbp", ["--filsam", RM_FILSAM], RM_WBP_CORR,
                 "kb_scatter_3ch", 1),
                ("wbp_ramp", ["--diameter", int(RM_WBP_DIAMETER * N)],
                 RM_WBP_RAMP_CORR, "kb_scatter_3ch", 1)):
            name = "reconstruct_art" if label.startswith("art") \
                else "reconstruct_wbp"
            prog = run(label, name, ["-i", rec_md, "-o", f(f"{label}.vol"),
                                     *args])
            vol = np.squeeze(Image(f(f"{label}.vol")).data)
            check(vol.shape == (N, N, N) and np.isfinite(vol).all(),
                  f"phase 11 {label}: volume of shape {vol.shape}")
            k = report[label]["launches"].get(kname, 0)
            check(k == launches, f"phase 11 {label}: {kname} launched {k} "
                  f"times, expected {launches}")
            corr = real_corr(vol, ref)
            q = recs[label] = {"corr": corr, kname: k}
            hist = getattr(prog, "residual_history", None)
            if hist is not None:
                q["residual_history"] = list(hist)
                limit(non_increasing(hist), f"phase 11 {label}: residuals "
                      f"{hist}")
            log(f"  {label}: correlation with the phantom {corr:.4f}"
                + ("" if hist is None else ", residual rms "
                   + " -> ".join(f"{v:.5f}" for v in hist)))
            limit(corr >= limit_corr, f"phase 11 {label}: correlation "
                  f"{corr:.4f} (limit {limit_corr})")
        quality["reconstruction"] = recs

        # (c) align_significant on phase 4's views and its 5-degree gallery
        asig_args = ["-i", views_md, "-r", cycle / "gallery.doc", "-o",
                     f("asig.xmd"), "--angDistance", RM_ASIG_ANG,
                     "--max_shift", RM_ASIG_MAX_SHIFT]
        run("align_significant", "align_significant", asig_args)
        k4 = report["align_significant"]["launches"].get("cross_spectrum", 0)
        batches = -(-V // MATCH_BATCH)
        check(k4 == 13 * batches, f"phase 11 align_significant: "
              f"cross_spectrum launched {k4} times, expected {13 * batches}")
        arows = md_rows(f("asig.xmd"))
        check(len(arows) == V, f"phase 11 align_significant: {len(arows)} "
              "rows")
        a_ids = np.array([int(r["itemId"]) for r in arows]) - 1
        d_true = directions_from_angles(np.stack(
            [poses["rot"][a_ids], poses["tilt"][a_ids]], 1))
        a_ang = np.degrees(np.arccos(np.clip(
            (d_true * effective_directions(arows)).sum(1), -1, 1)))
        a_within = float((a_ang <= 1.5 * GALLERY_RATE).mean())
        mesh_args = [str(a) for a in asig_args]
        mesh_args[mesh_args.index("-o") + 1] = f("asig_mesh.xmd")
        reps = run_mesh(report, root, "align_significant_mesh",
                        "align_significant", mesh_args, env_rendezvous=True)
        for r, rep in enumerate(reps):
            check(rep["launches"]["cross_spectrum"] > 0, f"phase 11 "
                  f"align_significant --mesh dp: rank {r} never launched "
                  "cross_spectrum")
        w_serial = column(f("asig.xmd"), "weight")
        w_mesh = column(f("asig_mesh.xmd"), "weight")
        mesh_err = max_rel(w_mesh, w_serial)
        same_ref = float((column(f("asig_mesh.xmd"), "ref")
                          == column(f("asig.xmd"), "ref")).mean())
        quality["align_significant"] = {
            "within_7.5_deg": a_within,
            "median_angle_deg": float(np.median(a_ang)),
            "mesh_weight_err": mesh_err, "mesh_same_ref": same_ref,
            "k4_launches": k4}
        log(f"  align_significant: {a_within:.4f} of the views within "
            f"{1.5 * GALLERY_RATE} deg of their direction (median "
            f"{np.median(a_ang):.2f} deg); --mesh dp weights within "
            f"{mesh_err:.2e} of the max, {same_ref:.4f} of the rows on the "
            "serial reference")
        limit(a_within >= 0.9, f"phase 11 align_significant: {a_within:.4f} "
              "of the views within 1.5 x the sampling (limit 0.9)")
        limit(mesh_err <= RM_MESH_TOL, f"phase 11 align_significant mesh: "
              f"weights {mesh_err:.2e} (limit {RM_MESH_TOL})")

        # (d) reconstruct_significant on 256 "class averages"
        (root / "sig").mkdir()
        run("reconstruct_significant", "reconstruct_significant",
            ["-i", f("sig.xmd"), "--odir", f("sig"), "--initvolumes",
             f("init.vol"), "--angularSampling", RM_SIG_RATE, "--iter",
             RM_SIG_ITERS, "--maxShift", RM_SIG_MAX_SHIFT])
        launches = report["reconstruct_significant"]["launches"]
        k3, k4s = (launches.get(k, 0) for k in ("kb_scatter_3ch",
                                                "cross_spectrum"))
        check(k3 == RM_SIG_ITERS and k4s == 13 * RM_SIG_ITERS,
              f"phase 11 reconstruct_significant: launches {launches}")
        vol = np.squeeze(Image(f("sig/significant_volume.vol")).data)
        check(vol.shape == (N, N, N) and np.isfinite(vol).all(),
              f"phase 11 reconstruct_significant: volume {vol.shape}")
        sig_corr = real_corr(vol, sig_ref)
        start_corr = real_corr(np.squeeze(Image(f("init.vol")).data),
                                 sig_ref)
        quality["reconstruct_significant"] = {
            "corr": sig_corr, "start_corr": start_corr,
            "kb_scatter_3ch": k3, "cross_spectrum": k4s}
        log(f"  reconstruct_significant: correlation with the phantom "
            f"{sig_corr:.4f} (the low-passed start {start_corr:.4f}); "
            f"launches K3 {k3}, K4 {k4s}")
        limit(sig_corr >= RM_SIG_CORR, f"phase 11 reconstruct_significant: "
              f"correlation {sig_corr:.4f} (limit {RM_SIG_CORR})")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["phase_s"] = time.perf_counter() - start
    log(f"  phase 11 took {report['phase_s']:.2f} s")
    log("recmisc " + json.dumps(report))
    limit.check()
    for k, (label, kname) in zip(kernels, (
            ("art_psart", "tri_scatter"), ("art_sirt", "tri_scatter"),
            ("wbp", "kb_scatter_3ch"))):
        k["launches"] = recs[label][kname]
    return kernels


# ---------------------------------------------------------------------------
# phase 12: phantoms and projection, continuous and discrete angular
# assignment, class averages, subtraction, residuals, SSNR, common lines
# ---------------------------------------------------------------------------

# the phantom description at N=128 (centres and sizes scaled to other n):
# (type, +/=, density, centre x y z, parameters whose first `sized` scale)
ANG_FEATURES = (
    ("sph", "+", 1.0, (12, -8, 5), (14,), 1),
    ("ell", "+", 0.6, (-15, 10, 0), (20, 10, 14, 30, 40, 10), 3),
    ("cyl", "+", 0.5, (0, -20, -10), (6, 8, 24, 60, 20, 0), 3),
    ("cub", "=", 0.8, (20, 20, -20), (10, 12, 8, 0, 30, 60), 3),
    ("gau", "+", 0.7, (-20, -20, 15), (5,), 1),
    ("con", "+", 0.4, (0, 25, 20), (8, 16, 15, 75, 20), 2))
ANG_FOURIER_TOL = 1e-5          # phantom_project vs FourierProjector
ANG_CHECK_VIEWS = 1000          # the views held against FourierProjector
ANG_PDB_ATOMS = 300             # the synthetic atomic model
ANG_PDB = ("--xdim", 64, "--sampling_rate", 2, "--high_sampling_rate", 1,
           "--nangles", 100)
ANG_PDB_SPREAD = 1e-4           # its projections' sums, relative spread
ANG_SIM_NOISE = 0.5             # simulate_microscope --noise, x the std
ANG_SIM_TOL = 1e-4              # its CTF and noise against numpy
ANG_SHIFT_STEP = 2              # angular_discrete_assign --shift_step
ANG_ORIENTATIONS = 3            # ... --number_orientations: the clouds
# ... keeping every gallery direction in the wavelet preselection and
# every in-plane angle of the polar grid (ROADMAP.md section 3, item 15)
ANG_DA_FLAGS = ("--keep", 100, "--pick", 0, "--psi_step", 1)
ANG_WITHIN = 0.9                # views within 1.5 x the gallery's step
ANG_CA_MIN = 3                  # classes of at least this many views
ANG_MESH_TOL = 1e-5             # class-average mesh sums against serial
ANG_SUB_RADIUS = 0.45           # the energy's circle, a share of N
ANG_SUBSET = 2000               # views of validation_nontilt, residuals, SSNR
ANG_TILT = (35.0, 40.0)         # tilt axis and tilt of the planted pairs
ANG_TILT_TOL = 0.1              # degrees
ANG_CL = (24, 64)               # angular_commonline: images and their size
# limits planned with tools/plan_angular.py (the reference package at
# N=64 on 1,000 views, 500 for the subsets; PERF.md section 6, PR 13): a
# correlation r read gives 1 - 2 (1 - r), an error or a left-over energy e
# gives 2 e, the SSNR and the common-line energy half the reading
ANG_REAL_CORR = 0.99781
ANG_ROT_DEG = {"pose": 0.9936, "full": 0.8050, "wavelet": 0.8196}
ANG_SHIFT_PX = {"pose": 0.0950, "full": 0.0696, "wavelet": 0.0768}
ANG_CA_CORR = 0.96548
ANG_SUB_ENERGY = 0.27432
ANG_MRA_ACC = 0.0065
ANG_VNT_SCORE = 0.996
ANG_CV_CORR = 0.92070
ANG_SSNR = 12.42
ANG_CCR_RATIO = 0.16216
ANG_CL_ENERGY = 0.7280


def angular_descr(n: int) -> str:
    """The .descr of the phase's phantom at size n."""
    k = n / 128
    lines = [f"{n} {n} {n} 0 1"]
    for t, op, dens, c, p, sized in ANG_FEATURES:
        vals = [v * k for v in c] + [v * k if i < sized else v
                                     for i, v in enumerate(p)]
        lines.append(f"{t} {op} {dens} " + " ".join(f"{v:g}" for v in vals))
    return "\n".join(lines) + "\n"


def synthetic_model(n_atoms: int, seed: int):
    """An atomic model of n_atoms atoms of C, N, O and S in a 40 A blob
    (numpy, from the seed), as core.pdb's AtomicModel."""
    from xmipp3_tpu_torch.core.pdb import AtomicModel
    rng = np.random.default_rng(seed + 21)
    els = list(rng.choice(["C", "N", "O", "S"], n_atoms, p=[.6, .2, .15, .05]))
    return AtomicModel(rng.normal(0, 8.0, (n_atoms, 3)), els,
                       rng.uniform(0.5, 2.0, n_atoms).astype(np.float32),
                       np.ones(n_atoms, np.float32))


def unflipped_rows(rows):
    """Assignment rows with every flipped row turned into the unflipped
    pose of the same view: the x-mirror of the projection at (rot, tilt)
    is the projection at (rot, tilt + 180) (a half turn about y), so
    (rot, tilt + 180, psi) with the same shifts registers the image as
    (rot, tilt, psi) with flip did. The continuous refinements take no
    flip."""
    out = []
    for r in rows:
        r = dict(r)
        if int(r.get("flip", 0)):
            r["angleTilt"] = float(r["angleTilt"]) + 180.0
        r["flip"] = 0
        out.append(r)
    return out


def pose_errors(rows, poses):
    """Median rotation angle (degrees) between each row's pose and its
    view's true pose, and median shift error (px); rows name their view by
    itemId."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    col = lambda k: np.array([float(r[k]) for r in rows])
    i = col("itemId").astype(int) - 1
    A = np.asarray(euler_matrix(col("angleRot"), col("angleTilt"),
                                col("anglePsi")), np.float64)
    T = np.asarray(euler_matrix(poses["rot"][i], poses["tilt"][i],
                                poses["psi"][i]), np.float64)
    cos = (np.einsum("nij,nij->n", A, T) - 1) / 2
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    sh = np.hypot(col("shiftX") - poses["sx"][i],
                  col("shiftY") - poses["sy"][i])
    return float(np.median(ang)), float(np.median(sh))


def directions_within(rows, poses, step: float) -> float:
    """Share of the rows whose effective direction is within 1.5 x step
    degrees of their view's true direction."""
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    i = np.array([int(r["itemId"]) for r in rows]) - 1
    d = directions_from_angles(np.stack([poses["rot"][i],
                                         poses["tilt"][i]], 1))
    ang = np.degrees(np.arccos(np.clip(
        (d * effective_directions(rows)).sum(1), -1, 1)))
    return float((ang <= 1.5 * step).mean())


def first_orientation(rows, n: int):
    """The best of each image's n consecutive rows."""
    return rows[::n]


def image_corrs(a, b):
    """Pearson correlation of each image pair of two (K, n, n) stacks."""
    a = a.reshape(len(a), -1).astype(np.float64)
    b = b.reshape(len(b), -1).astype(np.float64)
    a = a - a.mean(1, keepdims=True)
    b = b - b.mean(1, keepdims=True)
    return (a * b).sum(1) / np.maximum(np.sqrt((a * a).sum(1)
                                               * (b * b).sum(1)), 1e-30)


def masked_energy(stack, radius: float):
    """Sum of squares of a stack inside a centred circle of `radius` px."""
    n = stack.shape[-1]
    y, x = np.mgrid[0:n, 0:n] - n // 2
    inside = np.hypot(y, x) <= radius
    return float((stack.astype(np.float64)[:, inside] ** 2).sum())


def tilt_pairs(seed: int, n: int = 200):
    """Untilted coordinates and their tilted partners: a tilt of
    ANG_TILT[1] about an axis at ANG_TILT[0] degrees, and a shift."""
    rng = np.random.default_rng(seed + 23)
    u = rng.uniform(0, 4000, (n, 2))
    a, t = np.deg2rad(ANG_TILT[0]), np.deg2rad(ANG_TILT[1])
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return u, (R @ np.diag([1.0, np.cos(t)]) @ R.T @ u.T).T + [40.0, -25.0]


def commonline_set(seed: int, device):
    """ANG_CL[0] noiseless projections of the 8-blob phantom at size
    ANG_CL[1], uniform directions and psi (numpy's draws, the projections
    on `device`)."""
    count, n = ANG_CL
    rng = np.random.default_rng(seed + 25)
    rot = rng.uniform(0, 360, count)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, count)))
    psi = rng.uniform(0, 360, count)
    z = np.zeros(count)
    return projections(n, rot, tilt, psi, z, z, scaled_blobs(BLOBS8, n),
                       device=device)


def ssnr_set(seed: int, views: int, n: int, ref, device):
    """SSNR's inputs: `views` unshifted projections of ref at uniform poses
    with noise of 0.5 sigma, noise-only images at the same poses, and a
    noise volume of 1e-3 sigma (numpy noise; projections on `device`).
    Returns (signal images, noise images, noise volume, rot, tilt, psi)."""
    from xmipp3_tpu_torch.ops.project import FourierProjector
    rng = np.random.default_rng(seed + 27)
    rot = rng.uniform(0, 360, views).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, views))).astype(np.float32)
    psi = rng.uniform(0, 360, views).astype(np.float32)
    clean = FourierProjector(ref, device=device).project_euler(
        rot, tilt, psi).cpu().numpy()
    sig = float(clean.std())
    noise = (0.5 * sig) * rng.standard_normal(clean.shape, dtype=np.float32)
    nvol = (1e-3 * sig) * rng.standard_normal((n, n, n), dtype=np.float32)
    return clean + noise, noise, nvol, rot, tilt, psi


def ssnr_quality(table, n: int) -> float:
    """Median linear S_SSNR over the table's rows 1..n/8 (low frequencies)."""
    return float(np.median(table[1:n // 8 + 1, 3]))


def cross_at_aligneability_shape(refs, views, device):
    """K4 against its plain version at multireference_aligneability's
    shape: the ring spectra (61 rings, 512 angles, k = 257 at N=128) of a
    512-image chunk of the views and of the 5-degree --sampling gallery,
    masked as rotational_corr_matrix masks them, no mirror output; timed
    beside the plain version and one complex einsum."""
    import torch
    from xmipp3_tpu_torch.ops import cross
    from xmipp3_tpu_torch.ops.match import _masked_spectra, _ring_weights
    from xmipp3_tpu_torch.ops.polar import cartesian_to_polar, ring_ffts
    from xmipp3_tpu_torch.programs.angular_misc import \
        ProgMultireferenceAligneability
    n = refs.shape[-1]
    chunk = ProgMultireferenceAligneability.chunk
    f_refs = ring_ffts(cartesian_to_polar(refs, 2, n // 2 - 2))
    f_imgs = ring_ffts(cartesian_to_polar(torch.as_tensor(
        views[:chunk], device=device), 2, n // 2 - 2))
    w = _ring_weights(f_refs.shape[1], 2, refs.device)
    fi, fr, _ = _masked_spectra(f_refs, f_imgs, w)
    B, nr, K = fi.shape
    R = fr.shape[0]
    log(f"phase 12: cross_spectrum at multireference_aligneability's shape "
        f"B={B}, nr={nr}, R={R}, k={K}, no mirror")
    got = cross.cross_spectrum(fi, fr, w)
    want = cross.cross_spectrum_plain(fi, fr, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    log(f"  cross_spectrum: max|kernel-plain| = {err:.3e}, / max|plain| = "
        f"{rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL_CROSS,
          f"cross_spectrum at the aligneability shape: kernel disagrees with "
          f"its plain version ({rel:.3e} > {TOL_CROSS})")
    del got, want
    ms = time_ms(lambda: cross.cross_spectrum(fi, fr, w), reps=10)
    plain_ms = time_ms(lambda: cross.cross_spectrum_plain(fi, fr, w),
                       reps=3, warmup=1)
    wi = w[None, :, None]
    library_ms = time_ms(lambda: torch.einsum("brk,Rrk->bRk", fi * wi,
                                              fr.conj()), reps=5)
    nbytes = 8 * (B + R) * nr * K + 4 * nr + 8 * B * R * K
    nops = 8 * B * nr * R * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    log(f"  cross_spectrum: {ms:.4f} ms (plain {plain_ms:.4f} ms, complex "
        f"einsum {library_ms:.4f} ms); bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms)")
    src, replaces = KERNELS["cross_spectrum"]
    return {"name": "cross_spectrum_aligneability", "route": "cuda",
            "source": src, "replaces": replaces, "launches": None,
            "max_abs_err": err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": [B, nr, R, K]}


def angular_slice(seed, root: Path, cycle: Path, ctf_dir: Path, poses):
    """Phase 12 in root, on phase 4's views, gallery, assignment and
    phantom (cycle, with their true poses) and phase 6's CTF views
    (ctf_dir). Returns K4's entry at the aligneability shape, with the
    launches of the aligneability run."""
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.pdb import write_pdb
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    from xmipp3_tpu_torch.ops.project import FourierProjector
    from xmipp3_tpu_torch.programs import get_program
    root.mkdir(parents=True)
    f = lambda name: str(root / name)
    report, quality = {}, {}
    limit = Limits(12)
    run = partial(run_program, 12, report)

    def stack(name):
        return Image.read_stack(f(name))

    def finite(name, arr, shape):
        check(arr.shape == shape and np.isfinite(arr).all(),
              f"phase 12 {name}: output of shape {arr.shape} (expected "
              f"{shape}), finite {np.isfinite(arr).all()}")

    start = time.perf_counter()
    timing.enable_timing(True)
    vol_fn, gal_doc = cycle / "phantom.vol", cycle / "gallery.doc"
    try:
        # (a) phantoms and projection
        Path(f("ph.descr")).write_text(angular_descr(N))
        run("phantom_create", "phantom_create", ["-i", f("ph.descr"), "-o",
                                                 f("ph.vol")])
        ph = np.squeeze(Image(f("ph.vol")).data)
        finite("phantom_create", ph, (N, N, N))
        # the projections and the simulations on ANG_SUBSET views (the
        # real-space limit was planned on 1,000)
        proj_args = ["-i", f("ph.descr"), "--nangles", ANG_SUBSET, "--xdim",
                     N, "--seed", seed]
        run("project_fourier", "phantom_project",
            proj_args + ["-o", f("pf.stk")])
        run("project_real_space", "phantom_project",
            proj_args + ["-o", f("pr.stk"), "--method", "real_space"])
        pf, pr = stack("pf.stk"), stack("pr.stk")
        finite("phantom_project", pf, (ANG_SUBSET, N, N))
        finite("phantom_project --method real_space", pr, (ANG_SUBSET, N, N))
        ang = md_rows(f("pf.xmd"))
        rot, tilt, psi = (np.array([r[k] for r in ang], np.float32)
                          for k in ("angleRot", "angleTilt", "anglePsi"))
        want = FourierProjector(ph, device=DEVICE).project_euler(
            rot[:ANG_CHECK_VIEWS], tilt[:ANG_CHECK_VIEWS],
            psi[:ANG_CHECK_VIEWS]).cpu().numpy()
        fourier_err = max_rel(pf[:ANG_CHECK_VIEWS], want)
        rs_corr = image_corrs(pr, pf)
        write_pdb(f("model.pdb"), synthetic_model(ANG_PDB_ATOMS, seed))
        run("project_pdb", "phantom_project",
            ["-i", f("model.pdb"), "-o", f("pdb.stk"), *ANG_PDB])
        pp = stack("pdb.stk")
        finite("phantom_project (PDB)", pp, (ANG_PDB[-1], ANG_PDB[1],
                                             ANG_PDB[1]))
        sums = pp.sum(axis=(1, 2), dtype=np.float64)
        pdb_spread = float(sums.std() / abs(sums.mean()))
        sim_ctf = CTFDescription(sampling_rate=CTF_TS, voltage=CTF_KV,
                                 defocusU=12000.0, defocusV=12600.0,
                                 azimuthal_angle=30.0, Cs=CTF_CS, Q0=CTF_Q0)
        sim_ctf.write(f("sim.ctfparam"))
        sigma = ANG_SIM_NOISE * float(pf.std())
        run("simulate_ctf", "phantom_simulate_microscope",
            ["-i", f("pf.stk"), "-o", f("sim_ctf.mrcs"), "--ctf",
             f("sim.ctfparam")])
        run("simulate_ctf_noise", "phantom_simulate_microscope",
            ["-i", f("pf.stk"), "-o", f("sim.mrcs"), "--ctf",
             f("sim.ctfparam"), "--noise", sigma, "--seed", seed])
        sim_ctf_out, sim = stack("sim_ctf.mrcs"), stack("sim.mrcs")
        finite("phantom_simulate_microscope", sim, (ANG_SUBSET, N, N))
        c = plant_ctf(N, CTF_TS, 12000.0, 12600.0, 30.0)
        ctf_err = max_rel(sim_ctf_out[:ANG_CHECK_VIEWS], np.fft.irfft2(
            np.fft.rfft2(pf[:ANG_CHECK_VIEWS].astype(np.float64)) * c,
            s=(N, N)))
        noise = np.random.default_rng(seed).normal(0, sigma, sim.shape) \
            .astype(np.float32)
        added = sim - sim_ctf_out
        noise_err = float(np.abs(added - noise).max() / np.abs(sim).max())
        noise_std = float(added.std()) / sigma
        del pf, pr, want, sim, sim_ctf_out, noise, added
        quality["phantoms"] = {
            "fourier_vs_projector": fourier_err,
            "real_vs_fourier_corr_median": float(np.median(rs_corr)),
            "real_vs_fourier_corr_min": float(rs_corr.min()),
            "pdb_sum_spread": pdb_spread, "sim_ctf_err": ctf_err,
            "sim_noise_err": noise_err, "sim_noise_std_ratio": noise_std}
        log(f"  phantoms: Fourier projections vs FourierProjector "
            f"{fourier_err:.2e}; real space vs Fourier correlation median "
            f"{np.median(rs_corr):.4f} (min {rs_corr.min():.4f}); PDB "
            f"projections' sums spread {pdb_spread:.2e}; simulated CTF vs "
            f"numpy {ctf_err:.2e}, noise vs numpy {noise_err:.2e}, its std "
            f"{noise_std:.5f} of --noise")
        limit(fourier_err <= ANG_FOURIER_TOL, f"phase 12 phantom_project: "
              f"{fourier_err:.2e} from FourierProjector")
        limit(np.median(rs_corr) >= ANG_REAL_CORR, f"phase 12 real space vs "
              f"Fourier: correlation {np.median(rs_corr):.4f} (limit "
              f"{ANG_REAL_CORR})")
        limit(pdb_spread <= ANG_PDB_SPREAD, f"phase 12 PDB projections: "
              f"sums spread {pdb_spread:.2e}")
        limit(ctf_err <= ANG_SIM_TOL and noise_err <= ANG_SIM_TOL
              and abs(noise_std - 1) <= 0.01, f"phase 12 simulate: CTF "
              f"{ctf_err:.2e}, noise {noise_err:.2e}, std {noise_std:.4f}")
        for name in ("pf.stk", "pr.stk", "sim.mrcs", "sim_ctf.mrcs"):
            Path(f(name)).unlink()

        # (b) continuous assignment from phase 4's assignment
        rows4 = md_rows(cycle / "assigned.xmd")
        start_rows = unflipped_rows(rows4)
        err4 = pose_errors(start_rows, poses)
        MetaData.fromRows(start_rows[:ANG_SUBSET]).write(f("cont_sub.xmd"))
        err_sub = pose_errors(start_rows[:ANG_SUBSET], poses)
        cont = {"phase4": {"rot_deg": err4[0], "shift_px": err4[1]},
                "phase4_subset": {"rot_deg": err_sub[0],
                                  "shift_px": err_sub[1]}}
        # the three on the subset (planned on 1,000 views at N=64)
        for label, name, inp, extra in (
                ("pose", "angular_continuous_assign2", "cont_sub.xmd",
                 ["--optimizeAngles", "--optimizeShift"]),
                ("full", "angular_continuous_assign2", "cont_sub.xmd",
                 ["--optimizeAngles", "--optimizeShift", "--optimizeGray"]),
                ("wavelet", "angular_continuous_assign", "cont_sub.xmd",
                 ["--optimizeShift"])):
            prog = run(f"continuous_{label}", name,
                       ["-i", f(inp), "-o", f(f"cont_{label}.xmd"),
                        "--ref", vol_fn, *extra])
            got = md_rows(f(f"cont_{label}.xmd"))
            views = ANG_SUBSET
            check(len(got) == views, f"phase 12 {label}: {len(got)} rows")
            e_rot, e_sh = pose_errors(got, poses)
            base = err_sub
            first = float(np.mean(prog.result["cost_first"]))
            last = float(np.mean(prog.result["cost"]))
            cont[label] = {"rot_deg": e_rot, "shift_px": e_sh,
                           "cost_first": first, "cost_last": last}
            log(f"  continuous {label} ({views} views): median rotation "
                f"error {e_rot:.3f} deg, shift {e_sh:.3f} px (phase 4 "
                f"{base[0]:.3f} deg, {base[1]:.3f} px); mean cost "
                f"{first:.5f} -> {last:.5f}")
            limit(e_rot <= min(base[0], ANG_ROT_DEG[label])
                  and e_sh <= min(base[1], ANG_SHIFT_PX[label]),
                  f"phase 12 continuous {label}: {e_rot:.3f} deg, "
                  f"{e_sh:.3f} px")
            limit(last >= first, f"phase 12 continuous {label}: cost "
                  f"{first:.5f} -> {last:.5f}")
        quality["continuous"] = cont

        # (c) discrete assignment on phase 4's views
        views_md = cycle / "views.xmd"
        da_args = ["--ref", gal_doc, "--max_shift", MATCH_SHIFT,
                   "--shift_step", ANG_SHIFT_STEP, "--number_orientations",
                   ANG_ORIENTATIONS]
        run("discrete_assign", "angular_discrete_assign",
            ["-i", views_md, "-o", f("da.xmd"), *da_args, *ANG_DA_FLAGS])
        # the defaults, on a subset: the preselection correlates the
        # images' low bands with the gallery's without aligning them in
        # plane, and the 5-degree psi mask leaves the peak between masked
        # angles; both lose right directions (ROADMAP.md section 3, item
        # 15)
        MetaData.fromRows(md_rows(views_md)[:ANG_SUBSET]).write(
            f("views_sub.xmd"))
        run("discrete_assign_default", "angular_discrete_assign",
            ["-i", f("views_sub.xmd"), "-o", f("da_default.xmd"), *da_args])
        run("assignment_mag", "angular_assignment_mag",
            ["-i", views_md, "-o", f("mag.xmd"), "--refVol", vol_fn,
             "-angleStep", GALLERY_RATE, "-odir", f("magdir"), "--maxShift",
             MATCH_SHIFT])
        da_rows = md_rows(f("da.xmd"))
        check(len(da_rows) == ANG_ORIENTATIONS * VIEWS,
              f"phase 12 discrete: {len(da_rows)} rows")
        disc = {"discrete_assign_default_within": directions_within(
            first_orientation(md_rows(f("da_default.xmd")),
                              ANG_ORIENTATIONS), poses, GALLERY_RATE)}
        log(f"  discrete_assign with its defaults: "
            f"{disc['discrete_assign_default_within']:.4f} of {ANG_SUBSET} "
            f"views within {1.5 * GALLERY_RATE} deg")
        for label, rs in (("discrete_assign", first_orientation(
                da_rows, ANG_ORIENTATIONS)),
                ("assignment_mag", md_rows(f("mag.xmd")))):
            within = directions_within(rs, poses, GALLERY_RATE)
            k4 = report[label]["launches"].get("cross_spectrum", 0)
            disc[label] = {"within": within, "k4_launches": k4}
            log(f"  {label}: {within:.4f} of the views within "
                f"{1.5 * GALLERY_RATE} deg; cross_spectrum {k4} launches")
            check(k4 > 0, f"phase 12 {label} never launched cross_spectrum")
            limit(within >= ANG_WITHIN, f"phase 12 {label}: {within:.4f} "
                  f"within 1.5 x the step")
        quality["discrete"] = disc

        # (d) class averages, serially and on 2 ranks
        ca_args = ["-i", cycle / "assigned.xmd", "--lib", gal_doc,
                   "--split"]
        run("class_average", "angular_class_average",
            ca_args + ["-o", f("ca")])
        run_mesh(report, root, "class_average_mesh", "angular_class_average",
                 [*ca_args, "-o", f("ca_mesh")])
        avgs = stack("ca.stk")
        gal = Image.read_stack(str(cycle / "gallery.stk"))
        counts = np.array([int(r["classCount"]) for r in md_rows(f("ca.xmd"))])
        finite("angular_class_average", avgs, gal.shape)
        big = counts >= ANG_CA_MIN
        ca_corr = image_corrs(avgs[big], gal[big])
        mesh_err = max(max_rel(stack(f"ca_mesh{s}.stk"), stack(f"ca{s}.stk"))
                       for s in ("", "_split1", "_split2"))
        same_counts = [int(r["classCount"]) for r in
                       md_rows(f("ca_mesh.xmd"))] == counts.tolist()
        quality["class_average"] = {
            "classes": int(big.sum()), "corr_median": float(
                np.median(ca_corr)), "mesh_err": mesh_err,
            "mesh_counts_equal": same_counts}
        log(f"  class averages: {big.sum()} classes of >= {ANG_CA_MIN} views, "
            f"median correlation with their gallery image "
            f"{np.median(ca_corr):.4f}; mesh averages and halves within "
            f"{mesh_err:.2e} of the serial ones, counts equal {same_counts}")
        limit(np.median(ca_corr) >= ANG_CA_CORR, f"phase 12 class averages: "
              f"{np.median(ca_corr):.4f} (limit {ANG_CA_CORR})")
        limit(mesh_err <= ANG_MESH_TOL and same_counts, f"phase 12 class "
              f"average mesh: {mesh_err:.2e}, counts {same_counts}")

        # (e) subtraction and residuals on phase 6's CTF views
        pose = lambda i: {"angleRot": float(poses["rot"][i]),
                          "angleTilt": float(poses["tilt"][i]),
                          "anglePsi": float(poses["psi"][i]),
                          "shiftX": float(poses["sx"][i]),
                          "shiftY": float(poses["sy"][i])}
        MetaData.fromRows(dict(r, **pose(i)) for i, r in enumerate(
            md_rows(ctf_dir / "noisy.xmd"))).write(f("sub_in.xmd"))
        run("subtract_projection", "subtract_projection",
            ["-i", f("sub_in.xmd"), "--ref", vol_fn, "-o", f("sub"),
             "--sampling", CTF_TS])
        sub = stack("sub.mrcs")
        finite("subtract_projection", sub, (VIEWS, N, N))
        orig = Image.read_stack(str(ctf_dir / "ctf_noisy.mrcs"))
        ratio = masked_energy(sub, ANG_SUB_RADIUS * N) / \
            masked_energy(orig, ANG_SUB_RADIUS * N)
        del sub, orig
        MetaData.fromRows(md_rows(f("sub.xmd"))[:ANG_SUBSET]).write(
            f("sub_subset.xmd"))
        run("image_residuals", "image_residuals",
            ["-i", f("sub_subset.xmd"), "-o", f("ir")])
        covs = stack("ir.stk")
        finite("image_residuals", covs, (ANG_SUBSET, N, N))
        z = np.array([[r[k] for k in ("zScoreResMean", "zScoreResVar",
                                       "zScoreResCov")]
                      for r in md_rows(f("ir.xmd"))])
        finite("image_residuals z-scores", z, (ANG_SUBSET, 3))
        del covs
        quality["subtraction"] = {"energy_ratio": ratio,
                                  "residual_cov_z_median": float(
                                      np.median(z[:, 2]))}
        log(f"  subtract_projection: energy inside r < {ANG_SUB_RADIUS} N "
            f"{ratio:.4f} of the views'; image_residuals' divergence "
            f"median {np.median(z[:, 2]):.4f}")
        limit(ratio <= ANG_SUB_ENERGY, f"phase 12 subtraction: energy "
              f"{ratio:.4f} (limit {ANG_SUB_ENERGY})")
        for name in ("sub.mrcs", "ir.stk"):
            Path(f(name)).unlink()

        # (f) aligneability and validation
        run("aligneability", "multireference_aligneability",
            ["-i", cycle / "assigned.xmd", "--volume", vol_fn, "--sampling",
             GALLERY_RATE, "-o", f("mra.xmd")])
        mra = md_rows(f("mra.xmd"))
        acc_w = np.array([r["weightAlignabilityAccuracy"] for r in mra])
        finite("multireference_aligneability", acc_w, (VIEWS,))
        k4_mra = report["aligneability"]["launches"].get("cross_spectrum", 0)
        chunks = -(-VIEWS // get_program(
            "multireference_aligneability").chunk)
        check(k4_mra == chunks, f"phase 12 aligneability: cross_spectrum "
              f"launched {k4_mra} times, expected {chunks}")
        MetaData.fromRows(da_rows[:ANG_ORIENTATIONS * ANG_SUBSET]).write(
            f("clouds.xmd"))
        (root / "vnt").mkdir()
        prog = run("validation_nontilt", "validation_nontilt",
                   ["--i", f("clouds.xmd"), "--gallery", gal_doc, "--odir",
                    f("vnt")])
        finite("validation_nontilt", np.asarray(prog.P), (ANG_SUBSET,))
        quality["validation"] = {
            "aligneability_acc_median": float(np.median(acc_w)),
            "aligneability_k4": k4_mra, "nontilt_score": float(prog.score)}
        log(f"  aligneability: accuracy weight median {np.median(acc_w):.4f}"
            f" (K4 {k4_mra} launches); validation_nontilt score "
            f"{prog.score:.4f} over {ANG_SUBSET} clouds")
        limit(np.median(acc_w) >= ANG_MRA_ACC, f"phase 12 aligneability: "
              f"{np.median(acc_w):.4f} (limit {ANG_MRA_ACC})")
        limit(prog.score >= ANG_VNT_SCORE, f"phase 12 validation_nontilt: "
              f"{prog.score:.4f} (limit {ANG_VNT_SCORE})")
        from xmipp3_tpu_torch.core.sampling import Sampling
        ref_vol = np.squeeze(Image(str(vol_fn)).data)
        s = Sampling(GALLERY_RATE, "c1")
        kernel = cross_at_aligneability_shape(
            FourierProjector(ref_vol, device=DEVICE).project_euler(
                s.angles[:, 0].astype(np.float32),
                s.angles[:, 1].astype(np.float32),
                np.zeros(len(s.angles), np.float32)),
            Image.read_stack(str(cycle / "views.mrcs")), DEVICE)
        kernel["launches"] = k4_mra

        # (g) the other programs
        other = {}
        run("neighbourhood", "angular_neighbourhood",
            ["--i1", cycle / "assigned.xmd", "--i2", gal_doc, "-o",
             f("nb.xmd"), "--dist", 1.5 * GALLERY_RATE])
        nb = md_rows(f("nb.xmd"))
        listed = np.zeros(VIEWS, bool)
        for r in nb:
            listed[np.asarray(r["neighbors"], int) - 1] = True
        other["neighbourhood_listed"] = float(listed.mean())
        limit(len(nb) == len(gal) and listed.all(), f"phase 12 "
              f"neighbourhood: {len(nb)} rows, {listed.mean():.4f} listed")
        run("break_symmetry", "angular_break_symmetry",
            ["-i", cycle / "assigned.xmd", "-o", f("bs.xmd"), "--sym", "c4",
             "--seed", seed])
        bs = md_rows(f("bs.xmd"))
        col = lambda rs, k: np.array([float(r[k]) for r in rs])
        A0 = np.asarray(euler_matrix(*(col(rows4, k) for k in (
            "angleRot", "angleTilt", "anglePsi"))), np.float64)
        A1 = np.asarray(euler_matrix(*(col(bs, k) for k in (
            "angleRot", "angleTilt", "anglePsi"))), np.float64)
        # A1 = A0 Rz(k 90)^T: A0^T A1 is a turn about z by a multiple of 90
        Rz = np.einsum("nji,njk->nik", A0, A1)
        turn = np.degrees(np.arctan2(Rz[:, 0, 1], Rz[:, 0, 0]))
        sym_ok = float(((np.abs(Rz[:, 2, 2] - 1) < 1e-4)
                        & (np.abs((turn + 45) % 90 - 45) < 1e-2)).mean())
        other["break_symmetry_ok"] = sym_ok
        limit(sym_ok == 1.0, f"phase 12 break_symmetry: {sym_ok:.4f}")
        u, t = tilt_pairs(seed)
        for name, c in (("u", u), ("t", t)):
            MetaData.fromRows({"xcoor": float(a), "ycoor": float(b)}
                              for a, b in c).write(f(f"tilt_{name}.xmd"))
        prog = run("estimate_tilt_axis", "angular_estimate_tilt_axis",
                   ["--untilted", f("tilt_u.xmd"), "--tilted",
                    f("tilt_t.xmd"), "-o", f("axis.xmd")])
        other["tilt"] = [prog.tilt_axis_angle, prog.tilt_angle]
        limit(abs(prog.tilt_angle - ANG_TILT[1]) <= ANG_TILT_TOL,
              f"phase 12 tilt axis: tilt {prog.tilt_angle:.3f}")
        prog = run("compare_views", "compare_views",
                   ["-v1", vol_fn, "-v2", cycle / "cycle.vol", "-o",
                    f("cv.xmp"), "--degstep", 2 * GALLERY_RATE])
        cv = np.asarray(prog.corr_image)
        check(np.isfinite(cv).all(), "phase 12 compare_views: not finite")
        other["compare_views_median"] = float(np.median(cv))
        limit(np.median(cv) >= ANG_CV_CORR, f"phase 12 compare_views: "
              f"{np.median(cv):.4f} (limit {ANG_CV_CORR})")
        simg, nimg, nvol, srot, stilt, spsi = ssnr_set(
            seed, ANG_SUBSET, N, ref_vol, DEVICE)
        save_image(f("ssnr_s.mrcs"), simg)
        save_image(f("ssnr_n.mrcs"), nimg)
        save_image(f("noise.vol"), nvol)
        for tag in "sn":
            MetaData.fromRows(
                {"image": f"{i + 1}@{f(f'ssnr_{tag}.mrcs')}",
                 "angleRot": float(srot[i]), "angleTilt": float(stilt[i]),
                 "anglePsi": float(spsi[i])} for i in range(ANG_SUBSET)
            ).write(f(f"ssnr_{tag}.xmd"))
        prog = run("resolution_ssnr", "resolution_ssnr",
                   ["--signal", vol_fn, "--noise", f("noise.vol"),
                    "--sel_signal", f("ssnr_s.xmd"), "--sel_noise",
                    f("ssnr_n.xmd"), "-o", f("ssnr.txt"), "--gen_VSSNR",
                    "--VSSNR", f("vssnr.vol")])
        table = np.asarray(prog.ssnr_table)
        check(np.isfinite(table).all(), "phase 12 resolution_ssnr: table "
              "not finite")
        finite("resolution_ssnr --gen_VSSNR",
               np.squeeze(Image(f("vssnr.vol")).data), (N, N, N))
        other["ssnr_low"] = ssnr_quality(table, N)
        limit(other["ssnr_low"] >= ANG_SSNR, f"phase 12 SSNR: "
              f"{other['ssnr_low']:.4f} (limit {ANG_SSNR})")
        MetaData.fromRows(start_rows[:ANG_SUBSET]).write(f("ccr_in.xmd"))
        run("create_residuals", "continuous_create_residuals",
            ["-i", f("ccr_in.xmd"), "-o", f("ccr.xmd"), "--ref", vol_fn,
             "--optimizeShift", "--oresiduals", f("ccr.stk")])
        res = stack("ccr.stk")
        finite("continuous_create_residuals", res, (ANG_SUBSET, N, N))
        imgs = Image.read_stack(str(cycle / "views.mrcs"))
        ids = np.array([int(r["itemId"]) for r in start_rows[:ANG_SUBSET]])
        other["residual_ratio"] = float(
            (res.astype(np.float64) ** 2).sum()
            / (imgs[ids - 1].astype(np.float64) ** 2).sum())
        del res, imgs
        limit(other["residual_ratio"] <= ANG_CCR_RATIO, f"phase 12 "
              f"residuals: {other['residual_ratio']:.4f} (limit "
              f"{ANG_CCR_RATIO})")
        save_image(f("cl.mrcs"), commonline_set(seed, DEVICE))
        MetaData.fromRows({"image": f"{i + 1}@{f('cl.mrcs')}"}
                          for i in range(ANG_CL[0])).write(f("cl_in.xmd"))
        run("commonline", "angular_commonline",
            ["-i", f("cl_in.xmd"), "--oang", f("cl.xmd"), "--NGen", 1000,
             "--NGroup", 2])
        cl = md_rows(f("cl.xmd"))
        energy = float(cl[0]["cost"])
        check(len(cl) == ANG_CL[0] and np.isfinite(energy),
              f"phase 12 commonline: {len(cl)} rows, energy {energy}")
        other["commonline_energy"] = energy
        limit(energy >= ANG_CL_ENERGY, f"phase 12 commonline: energy "
              f"{energy:.4f} (limit {ANG_CL_ENERGY})")
        quality["other"] = other
        log(f"  neighbourhood: {listed.mean():.4f} of the views listed; "
            f"break_symmetry {sym_ok:.4f} symmetry copies; tilt axis "
            f"{other['tilt'][0]:.3f}, "
            f"tilt {other['tilt'][1]:.3f} deg; compare_views median "
            f"{other['compare_views_median']:.4f}; SSNR at low frequency "
            f"{other['ssnr_low']:.3f}; residual energy "
            f"{other['residual_ratio']:.4f} of the views'; commonline "
            f"energy {energy:.4f}")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["phase_s"] = time.perf_counter() - start
    log(f"  phase 12 took {report['phase_s']:.2f} s")
    log("angular " + json.dumps(report))
    limit.check()
    return kernel


# ---------------------------------------------------------------------------
# phase 13: image and class analysis (heterogeneity splits, halves
# restoration, symmetry search, image screening, dimension reduction,
# class analysis)
# ---------------------------------------------------------------------------

AN_STATE_VIEWS = 1000          # views of each of the two states
AN_MOVED_BLOB = 4              # BLOBS8's first extra blob moves ...
AN_MOVE = (0.0, 6.0, 0.0)      # ... by (z, y, x) px at N=128
AN_EMPTY = 500                 # noise-only images among the screened
AN_SCREEN_VIEWS = 2000         # phase 4's views screened
AN_OUTLIER_SHARE = 0.01        # planted outliers of the statistics screens
AN_OUTLIER_GAIN = 3.0          # their contrast, x the view
AN_EMPTY_T = 5.0               # image_eliminate_empty_particles -t
AN_ENERGY_CONF = 0.99          # image_eliminate_byEnergy --confidence
AN_CENTER = (3.0, -2.0)        # the views' common offset (x, y) px at N=128
AN_SORT_VIEWS = 200            # image_sort's chain (PR 15: 1,000 -> 200,
                               # its planned size, to pay for phase 14)
AN_CENTER_VIEWS = 1000         # image_find_center's views
AN_DIMRED_VIEWS, AN_DIMRED_N = 1000, 32   # phase 10's registered views
AN_RPCA_VIEWS, AN_RPCA_N, AN_RPCA_EIG = 2000, 64, 8
# --psi_step: 4 orientations a view keep the 2,000 x 4 x 64^2 samples
# under the 4e7 values of the serial path's exact SVD; at the default 15
# degrees the serial path takes its randomised sketch, which is not the
# mesh path's exact eigenbasis (ROADMAP.md section 3, item 18)
AN_RPCA_PSI = 90
AN_PCA_TOL = 1e-4              # matrix_dimred PCA against numpy's SVD
AN_MESH_ANGLE = 1e-3           # rad: the mesh basis against the serial one
AN_MESH_TOL = 1e-5             # the mesh filter bank against the serial one
AN_TV_VIEWS, AN_TV_WEIGHT = 512, 0.5   # denoising_tv: --weight x noise sigma
AN_SYM_N = 64                  # the symmetry volumes' size
AN_C4_AXIS = (33.0, 52.0)      # rot, tilt of the planted C4 axis
AN_C4_STEP = 5.0               # the search's step (its --rot/--tilt grid)
# the helix: AN_HELIX_COUNT blobs at radius AN_HELIX_R px, rise
# AN_HELIX_RISE A at AN_HELIX_TS A/px, twist AN_HELIX_TWIST degrees
AN_HELIX_RISE, AN_HELIX_TWIST, AN_HELIX_TS = 9.0, 40.0, 2.0
AN_HELIX_R, AN_HELIX_COUNT, AN_HELIX_SIGMA = 10.0, 15, 2.5
AN_HELIX_Z = (5.0, 13.0, 1.0)          # -z (A)
AN_HELIX_ROT = (30.0, 50.0, 2.0)       # --rotHelical (degrees)
AN_HALVES_FLAGS = ("--denoising", 1, "--deconvolution", 2, 0.2, 0.001,
                   "--filterBank", 0.02, 0.5, 1, 3, "--difference", 1, 1.5)
AN_FEATURES = ("--entropy", "--granulo", "--histdist", "--lbp", "--ramp",
               "--variance", "--zernike")
AN_FEATURE_LABELS = ("scoreByEntropy", "scoreByGranulo", "scoreByHistDist",
                     "scoreByLBP", "scoreByRamp", "scoreByVariance",
                     "scoreByZernike")
AN_FIRST_SPLIT_SHAPE = 8       # K3: one first_split subset
# K2: one first_split3 half set, gridded as every view weighted 0 or 1
AN_SPLIT3_SHAPE = 2 * AN_STATE_VIEWS
# limits planned with tools/plan_analysis.py (the reference package at
# N=64 on the same recipes, image_sort on 200 views; PERF.md section 6):
# a share, AUC or correlation r read gives 1 - 2 (1 - r), an error e
# gives 2 e (scaled to N), the SSNR and the rotational basis's variance
# share half the reading; each feature family's spread a quarter of it
# (the features vary across the views as the reference's do)
AN_PC1_CORR = 0.6257           # read 0.8128 (states differ: read so)
AN_SPLIT3_SHARE = 0.957        # read 0.9785
AN_EMPTY_ELIM = 1.0            # read 1.0 of the empties at -t 5
AN_EMPTY_KEPT = 1.0            # read 1.0 of the particles
AN_STATS_AUC = 1.0             # read 1.0
AN_ENERGY_AUC = 1.0            # read 1.0
AN_CENTER_ERR = 0.5            # px at N=128; read 0.125 px at N=64
AN_SSNR = 7.574                # read 15.148
AN_SORT_CORR = 0.8128          # read 0.9064 on 200 views
AN_LTSA_SEP = 1.0              # read 1.0
AN_RPCA_SHARE = 0.152          # read 0.3040
# the sketch's share of the expanded data's variance over the exact
# eigenbasis's share: read 0.99470 (the reference's sketch against its
# mesh path on phase 13's own data, tools/plan_analysis.py --part sketch)
AN_RPCA_SKETCH = 0.9894
AN_FEATURE_SPREAD = {          # a quarter of the medians read
    "scoreByEntropy": 0.0011, "scoreByGranulo": 0.0278,
    "scoreByHistDist": 0.0167, "scoreByLBP": 0.0379, "scoreByRamp": 4.118,
    "scoreByVariance": 0.0633, "scoreByZernike": 0.1220}


def analysis_states(n: int):
    """The two states of the heterogeneity set: BLOBS8 and BLOBS8 with its
    AN_MOVED_BLOB moved by AN_MOVE (both scaled to n)."""
    a = scaled_blobs(BLOBS8, n)
    b = list(a)
    cz, cy, cx, s, amp = b[AN_MOVED_BLOB]
    dz, dy, dx = (v * n / N for v in AN_MOVE)
    b[AN_MOVED_BLOB] = (cz + dz, cy + dy, cx + dx, s, amp)
    return a, b


def analysis_mask(n: int):
    """first_split's --mask: a sphere about the moved blob's two places
    (their midpoint; radius half the move plus three of its sigmas)."""
    cz, cy, cx, s, _ = scaled_blobs(BLOBS8, n)[AN_MOVED_BLOB]
    d = np.array(AN_MOVE) * n / N
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    r2 = ((z - cz - d[0] / 2) ** 2 + (y - cy - d[1] / 2) ** 2
          + (x - cx - d[2] / 2) ** 2)
    return (r2 <= (np.linalg.norm(d) / 2 + 3 * s) ** 2).astype(np.float32)


def analysis_hetero_set(n: int, per_state: int, seed: int, device):
    """per_state views of each state at uniform poses, random psi, shifts
    of +-3 px (x n/N) and noise of 0.5 sigma (phase 4's recipe; numpy's
    draws, projections on `device`). Returns (noisy, clean, rows'
    angles dict, state (0/1) a view)."""
    rng = np.random.default_rng(seed + 31)
    imgs, cleans, poses, state = [], [], [], []
    for k, blobs in enumerate(analysis_states(n)):
        rot = rng.uniform(0, 360, per_state)
        tilt = np.degrees(np.arccos(rng.uniform(-1, 1, per_state)))
        psi = rng.uniform(0, 360, per_state)
        sx, sy = rng.uniform(-3, 3, (2, per_state)) * n / N
        clean = projections(n, rot, tilt, psi, sx, sy, blobs, device=device)
        cleans.append(clean)
        poses.append(np.stack([rot, tilt, psi, sx, sy]))
        state.append(np.full(per_state, k))
    clean = np.concatenate(cleans)
    noisy = clean + (0.5 * clean.std()) * rng.standard_normal(
        clean.shape, dtype=np.float32)
    rot, tilt, psi, sx, sy = np.concatenate(poses, axis=1)
    return noisy, clean, dict(rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy), \
        np.concatenate(state)


def write_views(root: Path, name: str, imgs, poses=None):
    """imgs as root/name.mrcs and root/name.xmd (image, itemId and, given
    poses, angleRot/Tilt/Psi and shiftX/Y)."""
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    stk = root / f"{name}.mrcs"
    save_image(str(stk), np.asarray(imgs, np.float32))
    keys = (("angleRot", "rot"), ("angleTilt", "tilt"), ("anglePsi", "psi"),
            ("shiftX", "sx"), ("shiftY", "sy"))
    MetaData.fromRows(
        dict({"image": f"{i + 1}@{stk}", "itemId": i + 1},
             **({} if poses is None else
                {k: float(poses[v][i]) for k, v in keys}))
        for i in range(len(imgs))).write(str(root / f"{name}.xmd"))
    return root / f"{name}.xmd"


def axis_of(rot: float, tilt: float):
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    return np.asarray(euler_matrix(rot, tilt, 0.0), np.float64)[2]


def c4_volume(n: int):
    """BLOBS8 (scaled to n) and its three copies rotated by 90, 180 and
    270 degrees about the AN_C4_AXIS axis."""
    a = axis_of(*AN_C4_AXIS)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    blobs = []
    for k in range(4):
        th = np.pi / 2 * k
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        for cz, cy, cx, s, amp in scaled_blobs(BLOBS8, n):
            x, y, z = R @ np.array([cx, cy, cz])
            blobs.append((z, y, x, s, amp))
    return phantom(n, blobs)


def helix_volume(n: int):
    """AN_HELIX_COUNT Gaussian blobs on a helix about z: rise AN_HELIX_RISE
    A at AN_HELIX_TS A/px, twist AN_HELIX_TWIST degrees a blob."""
    rise = AN_HELIX_RISE / AN_HELIX_TS
    h = AN_HELIX_COUNT // 2
    return phantom(n, [(rise * k, AN_HELIX_R * np.sin(np.deg2rad(
        AN_HELIX_TWIST * k)), AN_HELIX_R * np.cos(np.deg2rad(
            AN_HELIX_TWIST * k)), AN_HELIX_SIGMA, 1.0)
        for k in range(-h, h + 1)])


def auc_upper(score, positive) -> float:
    """P(score of a positive > score of a negative), ties counting half."""
    score = np.asarray(score, np.float64)
    pos, neg = score[positive], score[~positive]
    greater = (pos[:, None] > neg[None, :]).mean()
    ties = (pos[:, None] == neg[None, :]).mean()
    return float(greater + 0.5 * ties)


def screening_set(views, seed: int):
    """Phase 13's screening stack: the views with their mean taken out
    (normalised particles), AN_OUTLIER_SHARE of them scaled by
    AN_OUTLIER_GAIN, then AN_EMPTY noise-only images of the views' std.
    Returns (stack, outlier mask over the views, empty mask)."""
    rng = np.random.default_rng(seed + 33)
    v = views - views.mean(axis=(1, 2), keepdims=True)
    out = np.zeros(len(v), bool)
    out[rng.choice(len(v), int(round(AN_OUTLIER_SHARE * len(v))),
                   replace=False)] = True
    v[out] *= AN_OUTLIER_GAIN
    empties = (float(v[~out].std()) * rng.standard_normal(
        (AN_EMPTY,) + v.shape[1:])).astype(np.float32)
    stack = np.concatenate([v, empties]).astype(np.float32)
    empty = np.zeros(len(stack), bool)
    empty[len(v):] = True
    return stack, out, empty


def nearest_centroid_share(Y, label) -> float:
    """The share of points whose nearest class centroid (in Y) is their
    own class's."""
    cls = np.unique(label)
    cent = np.stack([Y[label == c].mean(axis=0) for c in cls])
    d = ((Y[:, None, :] - cent[None]) ** 2).sum(-1)
    return float((cls[np.argmin(d, axis=1)] == label).mean())


def principal_angles(A, B):
    qa = np.linalg.qr(np.asarray(A, np.float64).reshape(len(A), -1).T)[0]
    qb = np.linalg.qr(np.asarray(B, np.float64).reshape(len(B), -1).T)[0]
    return np.arccos(np.clip(np.linalg.svd(qa.T @ qb, compute_uv=False),
                             -1, 1))


def analysis(seed, root: Path, cycle: Path, classify: Path, clean4, poses):
    """Phase 13 in root, on phase 4's views and true poses (cycle, clean4,
    poses) and phase 10's views and CL2D output (classify). Returns the
    kernels' entries of K3 at a first_split subset and K2 at a
    first_split3 half set, with their launches in the phase."""
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops.geo import apply_md_geometry
    from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
    root.mkdir(parents=True)
    f = lambda name: str(root / name)
    report, quality = {}, {}
    limit = Limits(13)
    run = partial(run_program, 13, report)
    mesh_run = partial(run_mesh, report, root)

    def vol(name):
        v = np.squeeze(Image(f(name)).data)
        check(np.isfinite(v).all(), f"phase 13 {name}: not finite")
        return v

    start = time.perf_counter()
    timing.enable_timing(True)
    try:
        # (a) heterogeneity: two states, the two first splits
        t0 = time.perf_counter()
        noisy, clean, hp, state = analysis_hetero_set(N, AN_STATE_VIEWS,
                                                      seed, DEVICE)
        het = write_views(root, "hetero", noisy, hp)
        vA, vB = (phantom(N, b) for b in analysis_states(N))
        log(f"phase 13: {2 * AN_STATE_VIEWS} views of two states (blob "
            f"{AN_MOVED_BLOB} of BLOBS8 moved by {AN_MOVE} px) made and "
            f"written in {time.perf_counter() - t0:.2f} s")
        save_image(f("het_mask.vol"), analysis_mask(N))
        prog = run("first_split", "classify_first_split",
                   ["-i", het, "--oroot", f("split"), "--mask",
                    "binary_file", f("het_mask.vol")])
        k3 = report["first_split"]["launches"].get("kb_scatter_3ch", 0)
        check(k3 == 101, f"phase 13 first_split: K3 launched {k3} times, "
              "expected 101 (the average and 100 subsets)")
        v1, v2, pc1 = vol("split_v1.vol"), vol("split_v2.vol"), \
            vol("split_pc1.vol")
        pc1_corr = abs(real_corr(pc1, vB - vA))
        c = [[real_corr(v, s) for s in (vA, vB)] for v in (v1, v2)]
        split_diff = (c[0][0] > c[0][1]) != (c[1][0] > c[1][1])
        prog3 = run("first_split3", "classify_first_split3",
                    ["-i", het, "--oroot", f("s3")])
        k2 = report["first_split3"]["launches"].get("tri_scatter", 0)
        check(k2 == 2 * prog3.sweeps_run + 2, f"phase 13 first_split3: K2 "
              f"launched {k2} times in {prog3.sweeps_run} sweeps")
        agree = float((prog3.sel1 == (state == 0)).mean())
        share3 = max(agree, 1.0 - agree)
        quality["first_split"] = {
            "pc1_corr": pc1_corr, "v_state_corr": c,
            "states_differ": bool(split_diff), "k3_launches": k3}
        quality["first_split3"] = {"own_half_share": share3,
                                   "sweeps": prog3.sweeps_run,
                                   "k2_launches": k2}
        log(f"  first_split: |corr(pc1, planted difference)| "
            f"{pc1_corr:.4f}; v1 vs (A, B) {c[0][0]:.4f} {c[0][1]:.4f}, v2 "
            f"{c[1][0]:.4f} {c[1][1]:.4f} (different states: "
            f"{split_diff}); first_split3: {share3:.4f} of the views in "
            f"their state's half after {prog3.sweeps_run} sweeps")
        limit(pc1_corr >= AN_PC1_CORR and split_diff, f"phase 13 "
              f"first_split: pc1 {pc1_corr:.4f} (limit {AN_PC1_CORR}), "
              f"states differ {split_diff}")
        limit(share3 >= AN_SPLIT3_SHARE, f"phase 13 first_split3: "
              f"{share3:.4f} (limit {AN_SPLIT3_SHARE})")
        split_kernels = [
            grid_at_views("kb_scatter_3ch_first_split", "kb",
                          hp["rot"][:AN_FIRST_SPLIT_SHAPE],
                          hp["tilt"][:AN_FIRST_SPLIT_SHAPE],
                          hp["psi"][:AN_FIRST_SPLIT_SHAPE], seed,
                          max_freq=0.25, phase=13),
            grid_at_views("tri_scatter_first_split3", "tri",
                          hp["rot"][:AN_SPLIT3_SHAPE],
                          hp["tilt"][:AN_SPLIT3_SHAPE],
                          hp["psi"][:AN_SPLIT3_SHAPE], seed, max_freq=0.25,
                          phase=13)]
        split_kernels[0]["launches"] = k3
        split_kernels[1]["launches"] = k2

        # (b) halves: phase 4's views at their true poses, even and odd
        keys = (("angleRot", "rot"), ("angleTilt", "tilt"),
                ("anglePsi", "psi"), ("shiftX", "sx"), ("shiftY", "sy"))
        stk4 = cycle / "views.mrcs"
        for h in (1, 2):
            MetaData.fromRows(
                dict({"image": f"{i + 1}@{stk4}", "itemId": i + 1},
                     **{k: float(poses[v][i]) for k, v in keys})
                for i in range(h - 1, len(poses["rot"]), 2)).write(
                    f(f"half{h}.xmd"))
            run(f"half{h}", "reconstruct_fourier",
                ["-i", f(f"half{h}.xmd"), "-o", f(f"half{h}.vol")])
        h1, h2 = vol("half1.vol"), vol("half2.vol")
        ref4 = np.squeeze(Image(str(cycle / "phantom.vol")).data)
        halves_args = ["--i1", f("half1.vol"), "--i2", f("half2.vol"),
                       *AN_HALVES_FLAGS]
        run("halves", "volume_halves_restoration",
            halves_args + ["--oroot", f("rest")])
        mesh_run("halves_mesh", "volume_halves_restoration",
                 halves_args + ["--oroot", f("rest_mesh")])
        restored = 0.5 * (vol("rest_restored1.vol") + vol("rest_restored2.vol"))
        plain_corr, rest_corr = real_corr(0.5 * (h1 + h2), ref4), \
            real_corr(restored, ref4)
        bank_err = max_rel(vol("rest_mesh_filterBank.vol"),
                           vol("rest_filterBank.vol"))
        quality["halves"] = {"plain_average_corr": plain_corr,
                             "restored_corr": rest_corr,
                             "mesh_filter_bank_err": bank_err}
        log(f"  halves: the restored map correlates {rest_corr:.5f} with "
            f"the phantom, the halves' average {plain_corr:.5f}; the mesh "
            f"filter bank within {bank_err:.2e} of the serial one")
        limit(rest_corr > plain_corr, f"phase 13 halves: restored "
              f"{rest_corr:.5f} <= plain average {plain_corr:.5f}")
        limit(bank_err <= AN_MESH_TOL, f"phase 13 halves: mesh filter bank "
              f"{bank_err:.2e} (limit {AN_MESH_TOL})")

        # (c) symmetry: a C4 axis and a helix
        save_image(f("c4.vol"), c4_volume(AN_SYM_N))
        prog = run("find_c4", "volume_find_symmetry",
                   ["-i", f("c4.vol"), "--sym", "rot", 4, "-o",
                    f("c4.xmd")])
        c4_found = [prog.best_rot, prog.best_tilt]
        a_found = axis_of(*c4_found)
        axis_err = float(np.degrees(np.arccos(min(1.0, abs(float(
            a_found @ axis_of(*AN_C4_AXIS)))))))
        save_image(f("helix.vol"), helix_volume(AN_SYM_N))
        prog = run("find_helix", "volume_find_symmetry",
                   ["-i", f("helix.vol"), "--sym", "helical", "-o",
                    f("helix.xmd"), "-z", *AN_HELIX_Z, "--rotHelical",
                    *AN_HELIX_ROT, "--sampling", AN_HELIX_TS])
        z_err = abs(prog.best_z - AN_HELIX_RISE)
        rot_err = abs(prog.best_rot - AN_HELIX_TWIST)
        quality["symmetry"] = {
            "c4_found": c4_found, "c4_axis_err_deg": axis_err,
            "helix_found": [prog.best_z, prog.best_rot], "helix_z_err_A": z_err,
            "helix_rot_err_deg": rot_err}
        log(f"  C4 axis found {axis_err:.3f} deg from the planted one; "
            f"helix: rise {prog.best_z:.3f} A (planted {AN_HELIX_RISE}), "
            f"twist {prog.best_rot:.3f} deg (planted {AN_HELIX_TWIST})")
        limit(axis_err <= AN_C4_STEP, f"phase 13 C4 axis {axis_err:.3f} "
              f"deg off (limit {AN_C4_STEP})")
        limit(z_err <= AN_HELIX_Z[2] and rot_err <= AN_HELIX_ROT[2],
              f"phase 13 helix: rise {z_err:.3f} A, twist {rot_err:.3f} "
              "deg off")

        # (d) image programs
        views4 = Image.read_stack(str(stk4))[:AN_SCREEN_VIEWS]
        scr, outl, empty = screening_set(views4, seed)
        scr_md = write_views(root, "screen", scr)
        prog = run("empty", "image_eliminate_empty_particles",
                   ["-i", scr_md, "-o", f("kept.xmd"), "-e", f("elim.xmd"),
                    "-t", AN_EMPTY_T])
        elim = prog.ratio <= AN_EMPTY_T
        elim_share = float(elim[empty].mean())
        kept_share = float((~elim[~empty]).mean())
        part = write_views(root, "part", scr[:len(views4)])
        prog = run("sort_by_statistics", "image_sort_by_statistics",
                   ["-i", part, "-o", f("stats.xmd")])
        stats_auc = auc_upper(prog.zscores, outl)
        sigma20 = float(np.median(scr[:len(views4)][~outl].var(axis=(1, 2))))
        prog = run("by_energy", "image_eliminate_byEnergy",
                   ["-i", part, "-o", f("energy.xmd"), "--confidence",
                    AN_ENERGY_CONF, "--sigma2", sigma20])
        bad = prog.energy_outliers
        energy_auc = 0.5 * (float(bad[outl].mean())
                            + float((~bad[~outl]).mean()))
        dx, dy = AN_CENTER
        moved = np.roll(views4[:AN_CENTER_VIEWS], (int(dy), int(dx)),
                        axis=(1, 2))
        ctr_md = write_views(root, "centre", moved)
        prog = run("find_center", "image_find_center",
                   ["-i", ctr_md, "--oroot", f("ctr")])
        center_err = float(np.hypot(prog.center[0] - (N / 2 + dx),
                                    prog.center[1] - (N / 2 + dy)))
        prog = run("ssnr", "image_ssnr", ["-i", part, "-o", f("ssnr.xmd")])
        ssnr = float(np.median(prog.ssnr))
        sort_md = write_views(root, "sort", views4[:AN_SORT_VIEWS])
        prog = run("sort", "image_sort", ["-i", sort_md, "--oroot",
                                          f("sorted")])
        sort_corr = float(np.median(prog.ccs[1:]))
        check(sorted(prog.order) == list(range(AN_SORT_VIEWS)),
              "phase 13 image_sort: the chain is not a permutation")
        quality["images"] = {
            "empty_eliminated": elim_share, "particles_kept": kept_share,
            "sort_by_statistics_auc": stats_auc, "by_energy_auc": energy_auc,
            "find_center_err_px": center_err, "ssnr_median": ssnr,
            "sort_median_corr": sort_corr}
        log(f"  screening: {elim_share:.4f} of the empties eliminated, "
            f"{kept_share:.4f} of the particles kept; outliers' AUC "
            f"{stats_auc:.4f} (statistics), {energy_auc:.4f} (energy); "
            f"centre {center_err:.3f} px off; SSNR median {ssnr:.3f}; the "
            f"sorted chain's median neighbour correlation {sort_corr:.4f}")
        limit(elim_share >= AN_EMPTY_ELIM and kept_share >= AN_EMPTY_KEPT,
              f"phase 13 empties: {elim_share:.4f} / {kept_share:.4f}")
        limit(stats_auc >= AN_STATS_AUC and energy_auc >= AN_ENERGY_AUC,
              f"phase 13 outliers: AUC {stats_auc:.4f} / {energy_auc:.4f}")
        limit(center_err <= AN_CENTER_ERR, f"phase 13 find_center: "
              f"{center_err:.3f} px (limit {AN_CENTER_ERR})")
        limit(ssnr >= AN_SSNR, f"phase 13 ssnr: {ssnr:.3f} (limit "
              f"{AN_SSNR})")
        limit(sort_corr >= AN_SORT_CORR, f"phase 13 image_sort: "
              f"{sort_corr:.4f} (limit {AN_SORT_CORR})")

        # image_vectorize -> matrix_dimred on phase 10's views, registered
        # by their planted poses and downsampled
        rows10 = md_rows(classify / "poses.xmd")[:AN_DIMRED_VIEWS]
        col10 = lambda k: np.array([float(r[k]) for r in rows10],
                                   np.float32)
        v10 = torch.as_tensor(Image.read_stack(str(classify / "views.mrcs"))
                              [:AN_DIMRED_VIEWS], device=DEVICE)
        reg = fourier_resize_2d(apply_md_geometry(
            v10, col10("anglePsi"), col10("shiftX"), col10("shiftY"),
            col10("flip") > 0.5), AN_DIMRED_N, AN_DIMRED_N).cpu().numpy()
        del v10
        lab10 = np.array([int(r["itemId"]) for r in rows10])
        label10 = np.asarray(classify_recipe(N, CLS_VIEWS, seed)["label"])[
            lab10 - 1]
        dim_md = write_views(root, "dimred_in", reg)
        run("vectorize", "image_vectorize", ["-i", dim_md, "-o",
                                             f("vectors.xmd")])
        run("dimred_pca", "matrix_dimred", ["-i", f("vectors.xmd"), "-o",
                                            f("pca.xmd"), "-m", "PCA",
                                            "--dout", 3])
        Y = np.stack([r["dimred"] for r in md_rows(f("pca.xmd"))])
        Xn = reg.reshape(len(reg), -1).astype(np.float64)
        U, S, _ = np.linalg.svd(Xn - Xn.mean(axis=0), full_matrices=False)
        want = U[:, :3] * S[:3]
        sgn = np.sign((Y * want).sum(axis=0))
        pca_err = float(np.abs(Y * sgn - want).max() / np.abs(want).max())
        run("dimred_ltsa", "matrix_dimred", ["-i", f("vectors.xmd"), "-o",
                                             f("ltsa.xmd"), "-m", "LTSA",
                                             "--dout", 3])
        Yl = np.stack([r["dimred"] for r in md_rows(f("ltsa.xmd"))])
        ltsa_sep = nearest_centroid_share(Yl, label10)
        quality["dimred"] = {"pca_vs_numpy_svd": pca_err,
                             "ltsa_nearest_centroid": ltsa_sep}
        log(f"  matrix_dimred: PCA within {pca_err:.2e} of numpy's float64 "
            f"SVD; LTSA: {ltsa_sep:.4f} of the views nearest their "
            "direction's centroid")
        limit(pca_err <= AN_PCA_TOL, f"phase 13 PCA: {pca_err:.2e}")
        limit(ltsa_sep >= AN_LTSA_SEP, f"phase 13 LTSA: {ltsa_sep:.4f} "
              f"(limit {AN_LTSA_SEP})")

        # image_rotational_pca, serial and over 2 ranks
        small = fourier_resize_2d(torch.as_tensor(
            views4[:AN_RPCA_VIEWS], device=DEVICE), AN_RPCA_N,
            AN_RPCA_N).cpu().numpy()
        rp_md = write_views(root, "rpca_in", small)
        rp_args = ["-i", rp_md, "--eigenvectors", AN_RPCA_EIG,
                   "--psi_step", AN_RPCA_PSI]
        run("rotational_pca", "image_rotational_pca",
            rp_args + ["--oroot", f("rpca")])
        mesh_run("rotational_pca_mesh", "image_rotational_pca",
                 rp_args + ["--oroot", f("rpca_mesh")])
        basis, basis_m = vol("rpca.stk"), vol("rpca_mesh.stk")
        ang = float(principal_angles(basis_m, basis).max())
        Xs = torch.as_tensor(small.reshape(len(small), -1), device=DEVICE,
                             dtype=torch.float64)
        Xs = Xs - Xs.mean(dim=0)
        Q = torch.linalg.qr(torch.as_tensor(basis.reshape(len(basis), -1).T,
                                            device=DEVICE,
                                            dtype=torch.float64))[0]
        share = float(((Xs @ Q) ** 2).sum() / (Xs ** 2).sum())
        del Xs, Q
        quality["rotational_pca"] = {"mesh_max_angle_rad": ang,
                                     "variance_share": share}
        log(f"  image_rotational_pca: the mesh basis within {ang:.2e} rad "
            f"of the serial one; the basis holds {share:.4f} of the "
            "views' variance")
        limit(ang <= AN_MESH_ANGLE, f"phase 13 rotational PCA mesh: "
              f"{ang:.2e} rad (limit {AN_MESH_ANGLE})")
        limit(share >= AN_RPCA_SHARE, f"phase 13 rotational PCA: share "
              f"{share:.4f} (limit {AN_RPCA_SHARE})")
        # the serial path's randomised sketch: the default --psi_step
        # (24 orientations a view, above the 4e7 values of the exact SVD),
        # against the exact eigenbasis of the same expanded data
        prog = run("rotational_pca_sketch", "image_rotational_pca",
                   ["-i", rp_md, "--eigenvectors", AN_RPCA_EIG, "--oroot",
                    f("rpca_sketch")])
        X = prog._expanded(torch.as_tensor(small, device=DEVICE),
                           np.random.default_rng(0))
        check(X.numel() > 4e7, f"phase 13 rotational PCA sketch: "
              f"{X.numel()} values take the exact path")
        Xc = (X - X.mean(dim=0)).double()
        del X
        exact = torch.linalg.eigh(Xc.T @ Xc)[1][:, -AN_RPCA_EIG:]
        sketch = vol("rpca_sketch.stk")
        Qs = torch.linalg.qr(torch.as_tensor(
            sketch.reshape(len(sketch), -1).T, device=DEVICE,
            dtype=torch.float64))[0]
        ratio = float(((Xc @ Qs) ** 2).sum() / ((Xc @ exact) ** 2).sum())
        sk_ang = float(principal_angles(
            sketch, exact.T.cpu().numpy().reshape(sketch.shape)).max())
        del Xc, Qs, exact
        quality["rotational_pca"].update(sketch_share_ratio=ratio,
                                         sketch_max_angle_rad=sk_ang)
        log(f"  image_rotational_pca sketch (--psi_step 15): its basis "
            f"holds {ratio:.6f} of the exact basis's share of the expanded "
            f"data's variance; largest principal angle {sk_ang:.4f} rad")
        limit(ratio >= AN_RPCA_SKETCH, f"phase 13 rotational PCA sketch: "
              f"share ratio {ratio:.6f} (limit {AN_RPCA_SKETCH})")

        # (e) class analysis on phase 10's CL2D output
        cl_images = classify / "cl2d" / "cl_images.xmd"
        prog = run("extract_features", "classify_extract_features",
                   ["-i", cl_images, "-o", f("features.xmd"),
                    *AN_FEATURES])
        spreads = {}
        for lab in AN_FEATURE_LABELS:
            F = prog.features[lab].astype(np.float64)
            check(np.isfinite(F).all(), f"phase 13 {lab}: not finite")
            spreads[lab] = float(np.median(F.std(axis=0) / np.maximum(
                np.abs(F.mean(axis=0)), 1e-30)))
        prog = run("evaluate_classes", "classify_evaluate_classes",
                   ["-i", cl_images, "-o", f("eval.xmd")])
        res = [m["resolutionFreqReal"] for m in prog.metrics]
        cls_rows = [r for r in md_rows(cl_images) if int(r["ref"]) == 1]
        MetaData.fromRows(cls_rows).write(f("class1.xmd"))
        prog = run("analyze_cluster", "classify_analyze_cluster",
                   ["-i", f("class1.xmd"), "-o", f("cluster.xmd"),
                    "--basis", f("cluster_basis.stk")])
        check(np.isfinite(prog.distances).all(), "phase 13 "
              "analyze_cluster: z-scores not finite")
        lev = sorted((classify / "cl2d").glob("level_*"))[-1].name
        prog = run("compare_classes", "classify_compare_classes",
                   ["--i1", classify / "cl2d" / lev / "cl_classes.xmd",
                    "--i2", classify / "cl2d_mesh" / lev / "cl_classes.xmd",
                    "-o", f("compare.txt")])
        cm = prog.comparison_matrix
        paired = float(cm.max(axis=1).sum() / max(cm.sum(), 1))
        noisy4 = Image.read_stack(str(stk4))[:AN_TV_VIEWS]
        sigma = float((noisy4 - clean4[:AN_TV_VIEWS]).std())
        tv_md = write_views(root, "tv_in", noisy4)
        run("denoising_tv", "denoising_tv",
            ["-i", tv_md, "-o", f("tv.mrcs"), "--weight",
             AN_TV_WEIGHT * sigma])
        den = Image.read_stack(f("tv.mrcs"))
        err_raw = float(np.sqrt(((noisy4 - clean4[:AN_TV_VIEWS]) ** 2)
                                .mean()))
        err_tv = float(np.sqrt(((den - clean4[:AN_TV_VIEWS]) ** 2).mean()))
        # four port commands that stay on the host (each process would
        # spend seconds reaching the card)
        cmd = f"{sys.executable} -m xmipp3_tpu_torch.programs"
        sort_md = f("sorted.xmd")
        good = [f"{cmd} image_header -i {f('tv.mrcs')} -v 0",
                f"{cmd} image_header -i {f('sorted.stk')} -v 0",
                f"{cmd} metadata_utilities -i {sort_md} -o {f('md1.xmd')} "
                "--operate sort maxCC -v 0",
                f"{cmd} metadata_split -i {sort_md} --oroot {f('part')} "
                "-n 2 -v 0"]
        Path(f("good.txt")).write_text("\n".join(good) + "\n")
        Path(f("bad.txt")).write_text("true\nexit 3\n")
        run("run", "run", ["-i", f("good.txt"), "-j", 2])
        run("run_failing", "run", ["-i", f("bad.txt"), "-j", 2], rc_want=1)
        check(Path(f("md1.xmd")).is_file(), "phase 13 run: the commands' "
              "outputs are missing")
        quality["class_analysis"] = {
            "feature_spread": spreads,
            "evaluate_resolution_median": float(np.median(res)),
            "compare_paired_share": paired,
            "tv_rms_raw": err_raw, "tv_rms_denoised": err_tv}
        log(f"  class analysis: feature spreads "
            + ", ".join(f"{k[7:]} {v:.3g}" for k, v in spreads.items())
            + f"; {len(res)} classes evaluated (median resolution "
            f"{np.median(res):.2f}); serial vs mesh CL2D classes paired "
            f"{paired:.4f}; denoising_tv rms from the clean views "
            f"{err_raw:.4f} -> {err_tv:.4f}")
        limit(all(spreads[k] >= v for k, v in AN_FEATURE_SPREAD.items()),
              f"phase 13 features: spreads {spreads} (limits "
              f"{AN_FEATURE_SPREAD})")
        limit(paired == 1.0, f"phase 13 compare_classes: {paired:.4f}")
        limit(err_tv < err_raw, f"phase 13 denoising_tv: {err_tv:.4f} >= "
              f"{err_raw:.4f}")
        report["quality"] = quality
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["phase_s"] = time.perf_counter() - start
    log(f"  phase 13 took {report['phase_s']:.2f} s")
    log("analysis " + json.dumps(report))
    limit.check()
    return split_kernels


# ---------------------------------------------------------------------------
# phase 14: micrograph picking, the misc programs and the volume programs
# ---------------------------------------------------------------------------

PK_SIZE = 4096                 # BASELINE config 2's frame (a 4k detector)
PK_TS = 1.34                   # A/px
PK_VIEWS = 300                 # planted views a micrograph
PK_CELL = 136                  # the positions' grid: one box and 8 px
PK_JITTER = 4                  # px: each position off its cell's centre
PK_NOISE = 1.0                 # x the views' std
PK_TEMPLATES = 16              # --ref: views at random directions
PK_MAX_PEAKS = 400
PK_WITHIN = 0.25               # a pick within a quarter box is a hit
MS_VIEWS = 2000                # phase 4's views the misc programs take
MS_PLANT_AB = (1.03, 0.02)     # grey levels: a, and b as a share of std
MS_GREY_RES = 2                # --max_resolution (A at 1 A/px): no low-pass
MS_SHIFT = 3.0                 # transform_center_image: plant in +-3 px
MS_DIST_RATE = 10.0            # angular_distribution_show --sampling
MS_BIG_N = 256                 # local adjustment and sharpening volumes
MS_BLOCK = 32                  # --neighborhood (A at 1 A/px)
MS_BLOCK_AT = (4, 4, 4)        # the scaled block (holding the centre)
MS_BLOCK_SCALE = 1.5
MS_ZONES = (0.2, 0.4, 3.0, 8.0)   # fine r < 0.2 n at 3 A, coarse to 0.4 n
MS_SHARP_ITERS = 10            # volume_local_sharpening -i
MS_SHARP_K = 1                 # -k: at the default 0.025 a voxel at 8 A
                               # weighs the 3 A band at 0.54, and the two
                               # zones' filters barely differ
MS_HIGH = ((0.08, 0.15), 0.2)  # cycles/px: a band below 1/6 A, and above
MS_BLOB, MS_BLUR = 1.5, 2.0     # px: the density's blobs and its blur
MS_BLOB_DENSITY = 1 / 256       # blobs a voxel
MS_SHARP_NOISE = 0.02
VL_N = 64                      # the volume programs' size
VL_PDB = ("--sampling", 2, "--size", VL_N)
VL_SHIFT = (3, -2, 4)          # volume_center's plant (z, y, x) voxels
VL_ALIGN = (30.0, 20.0, 0.0, 1.0, -2.0, 2.0)   # rot, tilt, psi, z, y, x
VL_STEP = 10.0                 # the grid's angular step (degrees)
VL_GRID = ("--rot", 0, 60, VL_STEP, "--tilt", 0, 40, VL_STEP,
           "-z", -2, 2, 1, "-y", -2, 2, 1, "-x", -2, 2, 1)
VL_REMOVED = 7                 # BLOBS8's blob that volume_subtraction finds
VL_C4_NOISE = 0.5              # x the C4 phantom's std
VL_PSEUDO = ("--sigma", 1, "--targetError", 1)
MISC_TOL = 1e-4                # numpy checks: exact or 1e-4 * max

# Limits planned with tools/plan_volume_misc.py on the reference package
# (the CPU, at these sizes but --big-n 128; PERF.md section 2): twice the
# shortfall of a share r (1 - 2 (1 - r)) or of a ratio below 1; for the
# C4 error ratio twice its distance from the ideal 1/2 (four copies of
# white noise averaged; C2 would give 1/sqrt(2)) over 1/2; the
# volume_from_pdb sums the reference's own to 1e-5; fixed bounds for the
# rest (0.5 px for the two centrings, one grid step for volume_align, 1e-4
# for the checks against numpy and the planted a and b).
PK_RECALL = {"ref": 0.9867, "svm": 0.78, "modes": 1.0}  # 0.9933, 0.89, 1.0
PK_PRECISION = {"ref": 1.0, "svm": 1.0, "modes": 1.0}   # read 1.0 each
MS_DIMRED_SEP = 0.72                # read 0.86
MS_GREY_A, MS_GREY_B = 1e-4, 1e-4   # read 0 and 1.0e-6
MS_CENTER_PX = 0.5                  # read 9.5e-5 px
MS_ADJUST_TOL = 1e-4                # read 2.4e-7 and 1.1e-7
VL_PDB_SUM = {"scattering": 95.25894927978516,
              "high_sampling": 706.2008056640625}
VL_CENTER_PX = 0.5                  # read 1.5e-5 px
VL_SUB_RECOVERED, VL_SUB_REST = 0.186, 1.029e-3   # read 0.5930, 5.14e-4
VL_SEGMENT_MASS = 0.2624                          # read 0.6312
VL_SYM_RATIO = 0.5039                             # read 0.4981


def picking_micrographs(n: int, size: int, views: int, seed: int, device):
    """Two size^2 micrographs, each with `views` views of the 8-blob
    phantom (BLOBS8 scaled to n; uniform directions, random psi) at
    distinct cells of a PK_CELL grid (at least one box apart), plus the
    PK_TEMPLATES template views; white noise of PK_NOISE x the views'
    std. numpy's draws, the views rendered on `device`. Returns (mics,
    positions (2, views, 2) as (x, y), templates)."""
    rng = np.random.default_rng(seed + 41)
    blobs = scaled_blobs(BLOBS8, n)
    cell = PK_CELL * n // N
    g = size // cell
    total = 2 * views + PK_TEMPLATES
    rot = rng.uniform(0, 360, total)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, total)))
    psi = rng.uniform(0, 360, total)
    z = np.zeros(total)
    imgs = projections(n, rot, tilt, psi, z, z, blobs, device=device)
    sigma = float(imgs[:2 * views].std())
    mics, pos = [], []
    h = n // 2
    for m in range(2):
        cells = rng.choice(g * g, views, replace=False)
        xy = np.stack([cells % g, cells // g], 1) * cell + cell // 2 \
            + rng.integers(-PK_JITTER, PK_JITTER + 1, (views, 2))
        xy = np.clip(xy, h, size - h)
        mic = (PK_NOISE * sigma) * rng.standard_normal((size, size),
                                                       dtype=np.float32)
        for (x, y), v in zip(xy, imgs[m * views:(m + 1) * views]):
            mic[y - h:y + h, x - h:x + h] += v
        mics.append(mic)
        pos.append(xy)
    return mics, np.stack(pos), imgs[2 * views:]


def recall_precision(picks, truth, box: int):
    """(the share of planted positions with a pick within PK_WITHIN x box,
    the share of picks within that of a planted position)."""
    p = np.asarray(picks, np.float64).reshape(-1, 2)
    t = np.asarray(truth, np.float64)
    if not len(p):
        return 0.0, 0.0
    d = np.hypot(p[:, None, 0] - t[None, :, 0], p[:, None, 1] - t[None, :, 1])
    hit = d <= PK_WITHIN * box
    return float(hit.any(axis=0).mean()), float(hit.any(axis=1).mean())


def c4_z_volume(n: int):
    """BLOBS8 (scaled to n) and its copies turned by 90, 180 and 270
    degrees about z: a C4 map about the axis --sym c4 names."""
    blobs = []
    for cz, cy, cx, s, a in scaled_blobs(BLOBS8, n):
        for k in range(4):
            c, si = round(np.cos(np.pi / 2 * k)), round(np.sin(np.pi / 2 * k))
            blobs.append((cz, si * cx + c * cy, c * cx - si * cy, s, a))
    return phantom(n, blobs)


def rotation_angle_deg(A, B) -> float:
    """The angle of the rotation taking B's 3x3 part to A's, degrees."""
    R = np.asarray(A, np.float64)[:3, :3] @ np.asarray(B, np.float64)[:3, :3].T
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


def misc_volume_readings(seed, root: Path, run, device, clean4, poses4,
                         classify: Path, n: int = N, pick_size: int = PK_SIZE,
                         pick_views: int = PK_VIEWS, big_n: int = MS_BIG_N,
                         vol_n: int = VL_N, sharp_k: float = MS_SHARP_K):
    """Phase 14's programs on its recipes: run(label, program, args) runs
    one program (the port's on the card in this script, the reference's
    on the CPU in tools/plan_volume_misc.py) and returns it; the data are
    made on `device`. clean4 / poses4 are phase 4's clean views and true
    poses (the first MS_VIEWS are used), classify phase 10's output.
    sharp_k is volume_local_sharpening's -k. Returns the quality
    readings."""
    from scipy import ndimage

    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.pdb import write_pdb
    from xmipp3_tpu_torch.ops.geo import apply_affine_3d, apply_md_geometry
    from xmipp3_tpu_torch.ops.project import FourierProjector
    from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
    from xmipp3_tpu_torch.programs.volume_programs import ProgVolumeAlign
    f = lambda name: str(root / name)
    load = lambda name: np.squeeze(Image(f(name)).data)
    q = {}

    def write_pos(name, xy):
        MetaData.fromRows({"xcoor": int(x), "ycoor": int(y)}
                          for x, y in xy).write(f(name))
        return f(name)

    def picked(fn):
        return [(float(r["xcoor"]), float(r["ycoor"])) for r in md_rows(fn)]

    # (a) picking at config 2's size
    t0 = time.perf_counter()
    mics, pos, templ = picking_micrographs(n, pick_size, pick_views, seed,
                                           device)
    for m, mic in enumerate(mics):
        save_image(f(f"mic{m + 1}.mrc"), mic, sampling=PK_TS)
    save_image(f("templates.mrcs"), templ)
    pos1, pos2 = write_pos("mic1.pos", pos[0]), write_pos("mic2.pos", pos[1])
    q["data_s"] = time.perf_counter() - t0
    h = n // 2
    run("scissor", "micrograph_scissor",
        ["-i", f("mic1.mrc"), "--pos", pos1, "-o", f("parts1.stk"),
         "--Xdim", n])
    parts = Image.read_stack(f("parts1.stk"))
    crop = np.stack([mics[0][y - h:y + h, x - h:x + h] for x, y in pos[0]])
    q["scissor_max_abs_diff"] = float(np.abs(parts - crop).max())
    noise_pos = write_pos("noise1.pos", pos[0])
    run("scissor_noise", "micrograph_scissor",
        ["-i", f("mic1.mrc"), "--pos", noise_pos, "-o", f("noise1.stk"),
         "--Xdim", n, "--extractNoise", pick_views])
    npos = np.array(picked(noise_pos))
    near = ((np.abs(npos[:, None, 0] - pos[0][None, :, 0]) < h)
            & (np.abs(npos[:, None, 1] - pos[0][None, :, 1]) < h)).any(1)
    q["noise_boxes"] = int(len(Image.read_stack(f("noise1.stk"))))
    q["noise_on_particles"] = int(near.sum())
    prog = run("pick_ref", "micrograph_automatic_picking",
               ["-i", f("mic1.mrc"), "-o", f("pick_ref.pos"),
                "--particleSize", n, "--ref", f("templates.mrcs"),
                "--max_peaks", PK_MAX_PEAKS])
    q["pick_ref"] = dict(zip(("recall", "precision"), recall_precision(
        picked(f("pick_ref.pos")), pos[0], n)), picked=prog.n_picked)
    prog = run("train_svm", "micrograph_automatic_picking",
               ["-i", f("mic1.mrc"), "--particleSize", n, "--trainSVM",
                "--trainPos", f("parts1.xmd"), "--trainNeg", f("noise1.xmd"),
                "--svm", f("model")])
    svm_acc = prog.train_accuracy
    prog = run("pick_svm", "micrograph_automatic_picking",
               ["-i", f("mic2.mrc"), "-o", f("pick_svm.pos"),
                "--particleSize", n, "--ref", f("templates.mrcs"),
                "--max_peaks", PK_MAX_PEAKS, "--svm", f("model")])
    q["pick_svm"] = dict(zip(("recall", "precision"), recall_precision(
        picked(f("pick_svm.pos")), pos[1], n)), picked=prog.n_picked,
        train_accuracy=svm_acc)
    run("buildinv", "micrograph_automatic_picking",
        ["-i", f("mic1.mrc"), "--particleSize", n, "--mode", "buildinv",
         pos1, "--model", f("auto")])
    prog = run("train", "micrograph_automatic_picking",
               ["-i", f("mic1.mrc"), "--particleSize", n, "--mode", "train",
                "--model", f("auto"), "--outputRoot", f("out1")])
    acc = prog.train_accuracy
    prog = run("autoselect", "micrograph_automatic_picking",
               ["-i", f("mic2.mrc"), "--particleSize", n, "--mode",
                "autoselect", "--model", f("auto"), "--outputRoot",
                f("out2")])
    q["pick_modes"] = dict(zip(("recall", "precision"), recall_precision(
        picked(f"particles_auto@{f('out2')}.pos"), pos[1], n)),
        picked=prog.n_picked, train_accuracy=acc)
    del mics

    # (b) the misc programs
    V = min(MS_VIEWS, len(clean4))
    rows10 = md_rows(classify / "poses.xmd")[:AN_DIMRED_VIEWS]
    col10 = lambda k: np.array([float(r[k]) for r in rows10], np.float32)
    v10 = Image.read_stack(str(classify / "views.mrcs"))[:AN_DIMRED_VIEWS]
    reg = fourier_resize_2d(apply_md_geometry(
        v10, col10("anglePsi"), col10("shiftX"), col10("shiftY"),
        col10("flip") > 0.5, device=device), AN_DIMRED_N,
        AN_DIMRED_N).cpu().numpy()
    lab10 = np.array([int(r["itemId"]) for r in rows10])
    label10 = np.asarray(classify_recipe(n, CLS_VIEWS, seed)["label"])[
        lab10 - 1]
    dim_md = write_views(root, "dimred_in", reg)
    run("dimred_pca", "transform_dimred",
        ["-i", dim_md, "-o", f("dimred_pca.xmd"), "--method", "PCA",
         "--dout", 3, "--distance", "Euclidean"])
    Y = np.stack([r["dimred"] for r in md_rows(f("dimred_pca.xmd"))])
    Xn = reg.reshape(len(reg), -1).astype(np.float64)
    U, S, _ = np.linalg.svd(Xn - Xn.mean(axis=0), full_matrices=False)
    want = U[:, :3] * S[:3]
    sgn = np.sign((Y * want).sum(axis=0))
    q["dimred_pca_vs_numpy_svd"] = float(np.abs(Y * sgn - want).max()
                                         / np.abs(want).max())
    run("dimred_corr", "transform_dimred",
        ["-i", dim_md, "-o", f("dimred_corr.xmd"), "--method", "PCA",
         "--dout", 3])
    Yc = np.stack([r["dimred"] for r in md_rows(f("dimred_corr.xmd"))])
    q["dimred_corr_nearest_centroid"] = nearest_centroid_share(Yc, label10)

    rng = np.random.default_rng(seed + 43)
    clean = np.asarray(clean4[:V], np.float32)
    noisy = clean + (0.5 * clean.std()) * rng.standard_normal(
        clean.shape, dtype=np.float32)
    p4 = {k: np.asarray(v)[:V] for k, v in poses4.items()}
    views_md = write_views(root, "views", noisy, p4)
    run("odd_even", "image_odd_even",
        ["-i", f("views.mrcs"), "-o", f("odd.mrcs"), "-e", f("even.mrcs"),
         "--sum_frames"])
    q["odd_even_max_abs_diff"] = max(
        float(np.abs(load("odd.mrcs") - noisy[0::2]).max()),
        float(np.abs(load("even.mrcs") - noisy[1::2]).max()),
        float(np.abs(load("odd_avg.mrc") - noisy[0::2].mean(0)).max()
              / np.abs(noisy[0::2].mean(0)).max()))
    prog = run("distribution", "angular_distribution_show",
               ["-i", views_md, "-o", f("dist.xmd"), "--sampling",
                MS_DIST_RATE])
    drows = md_rows(f("dist.xmd"))
    d_ref = np.array([[r["X"], r["Y"], r["Z"]] for r in drows])
    rr, tt = np.deg2rad(p4["rot"]), np.deg2rad(p4["tilt"])
    d_exp = np.stack([np.cos(rr) * np.sin(tt), np.sin(rr) * np.sin(tt),
                      np.cos(tt)], 1)
    counts = np.bincount(np.argmax(d_exp @ d_ref.T, axis=1),
                         minlength=len(d_ref))
    q["distribution_count_diff"] = int(np.abs(
        counts - np.array([r["weight"] for r in drows])).max())

    # grey levels on the phantom's Fourier views at the true poses (the
    # program's own projector), centring on unshifted analytic views
    ph = phantom(n, scaled_blobs(BLOBS8, n))
    save_image(f("phantom.vol"), ph)
    P = FourierProjector(ph, device=device).project_euler(
        p4["rot"], p4["tilt"], p4["psi"]).cpu().numpy()
    a, b = MS_PLANT_AB
    b_abs = b * float(P.std())
    write_views(root, "grey", a * P + b_abs, p4)
    run("grey_levels", "transform_adjust_image_grey_levels",
        ["-i", f("grey.xmd"), "-o", f("grey_out.mrcs"),
         "--save_metadata_stack", f("grey_out.xmd"), "--ref",
         f("phantom.vol"), "--max_resolution", MS_GREY_RES])
    grows = md_rows(f("grey_out.xmd"))
    q["grey_a_err"] = float(np.median(np.abs(
        np.array([r["continuousA"] for r in grows]) - a)))
    q["grey_b_err"] = float(np.median(np.abs(
        np.array([r["continuousB"] for r in grows]) - b_abs))
        / float(P.std()))
    del P
    z = np.zeros(V)
    flat = projections(n, p4["rot"], p4["tilt"], p4["psi"], z, z,
                       scaled_blobs(BLOBS8, n), device=device)
    shift = rng.uniform(-MS_SHIFT, MS_SHIFT, (2, V))
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    moved = np.fft.irfft2(np.fft.rfft2(flat) * np.exp(
        -2j * np.pi * (fx * shift[0][:, None, None]
                       + fy * shift[1][:, None, None])), s=(n, n))
    cen = {}
    for name, stack in (("flat", flat), ("moved", moved)):
        write_views(root, f"c_{name}", stack.astype(np.float32))
        run(f"center_{name}", "transform_center_image",
            ["-i", f(f"c_{name}.xmd"), "-o", f(f"c_{name}_out.mrcs"),
             "--save_metadata_stack", f(f"c_{name}_out.xmd"),
             "--save_metadata_transform"])
        cr = md_rows(f(f"c_{name}_out.xmd"))
        cen[name] = np.array([[r["shiftX"], r["shiftY"]] for r in cr]).T
    q["center_image_err_px"] = float(np.median(np.hypot(
        *(cen["moved"] - cen["flat"] + shift))))
    binary = (flat > 0.3 * flat.max()).astype(np.float32)
    save_image(f("binary.mrcs"), binary)
    run("morphology", "transform_morphology",
        ["-i", f("binary.mrcs"), "-o", f("morph.mrcs"), "--binaryOperation",
         "dilation", "--size", 2])
    st = ndimage.generate_binary_structure(2, 2)
    want = np.stack([ndimage.binary_dilation(im > 0.5, st, iterations=2)
                     for im in binary]).astype(np.float32)
    q["morphology_diff_pixels"] = int((load("morph.mrcs") != want).sum())
    del flat, moved, noisy, clean

    # local adjustment and sharpening on big_n^3 maps
    big = phantom(big_n, scaled_blobs(BLOBS8, big_n))
    blk = MS_BLOCK * big_n // MS_BIG_N
    sl = tuple(slice(k * blk, (k + 1) * blk) for k in MS_BLOCK_AT)
    scaled = big.copy()
    scaled[sl] *= MS_BLOCK_SCALE
    save_image(f("big.vol"), big)
    save_image(f("big_scaled.vol"), scaled)
    (root / "occ").mkdir()
    run("local_adjust", "local_volume_adjust",
        ["--i1", f("big.vol"), "--i2", f("big_scaled.vol"), "-o",
         f("adjusted.vol"), "--neighborhood", blk, "--save", f("occ")])
    occ = np.squeeze(Image(f("occ/Occupancy.mrc")).data)
    q["local_adjust_scale_err"] = float(np.abs(occ[sl] - MS_BLOCK_SCALE)
                                        .max())
    q["local_adjust_out_err"] = float(np.abs(load("adjusted.vol") - big)
                                      .max() / big.max())
    # sharpening: a density of Gaussian blobs (sigma MS_BLOB px at random
    # places inside r < MS_ZONES[1] n, MS_BLOB_DENSITY a voxel) blurred by
    # a Gaussian of MS_BLUR px, with noise of MS_SHARP_NOISE x its std;
    # resolution MS_ZONES[2] A inside r < MS_ZONES[0] n and MS_ZONES[3] A
    # to MS_ZONES[1] n, unmeasured (0) outside. A zone's tilt is the
    # output's gain of energy above MS_HIGH[1] cycles/px over its gain in
    # (MS_HIGH[0][0], MS_HIGH[0][1]]: sharpening to 3 A lifts the first
    # more than sharpening to 8 A does
    import torch
    c = np.arange(big_n) - big_n // 2
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    fine = r < MS_ZONES[0] * big_n
    coarse = (r >= MS_ZONES[0] * big_n) & (r < MS_ZONES[1] * big_n)
    res = np.where(fine, MS_ZONES[2], np.where(coarse, MS_ZONES[3], 0.0))
    w2 = torch.as_tensor(np.fft.fftfreq(big_n)[:, None, None] ** 2
                         + np.fft.fftfreq(big_n)[None, :, None] ** 2
                         + np.fft.rfftfreq(big_n)[None, None, :] ** 2,
                         device=device)
    srng = np.random.default_rng(seed + 45)
    inside = np.flatnonzero(r < MS_ZONES[1] * big_n)
    spikes = np.zeros(big_n ** 3, np.float32)
    spikes[srng.choice(inside, int(MS_BLOB_DENSITY * len(inside)),
                       replace=False)] = 1.0
    sig = np.hypot(MS_BLOB, MS_BLUR)
    blurred = torch.fft.irfftn(torch.fft.rfftn(torch.as_tensor(
        spikes.reshape((big_n,) * 3), device=device).double())
        * torch.exp(-2 * np.pi ** 2 * sig ** 2 * w2), (big_n,) * 3) \
        .float().cpu().numpy()
    del spikes
    blurred += (MS_SHARP_NOISE * blurred.std()) * srng.standard_normal(
        blurred.shape, dtype=np.float32)
    save_image(f("blurred.vol"), blurred)
    save_image(f("resmap.vol"), res.astype(np.float32))
    run("sharpening", "volume_local_sharpening",
        ["--vol", f("blurred.vol"), "--resolution_map", f("resmap.vol"),
         "-o", f("sharp.vol"), "--md", f("sharp.xmd"), "--sampling", 1,
         "-i", MS_SHARP_ITERS, "-k", sharp_k])
    sharp = load("sharp.vol")
    (lo, hi), top = MS_HIGH
    masks = {"mid": (w2 > lo ** 2) & (w2 <= hi ** 2), "top": w2 > top ** 2}
    zones = {k: torch.as_tensor(z, device=device)
             for k, z in (("fine", fine), ("coarse", coarse))}
    energy = {}      # (volume, band, zone) -> energy, float64 on device
    for vname, v in (("sharp", sharp), ("blurred", blurred)):
        F = torch.fft.rfftn(torch.as_tensor(v, device=device).double())
        for bname, m in masks.items():
            b = torch.fft.irfftn(F * m, v.shape)
            for zname, zone in zones.items():
                energy[vname, bname, zname] = float((b[zone] ** 2).sum())
        del F
    gain = lambda b, z: energy["sharp", b, z] / energy["blurred", b, z]
    q["sharpening"] = {
        "finite": bool(np.isfinite(sharp).all()),
        "iterations": int(md_rows(f("sharp.xmd"))[0]["iterationNumber"]),
        **{f"tilt_{z}": gain("top", z) / gain("mid", z) for z in zones}}
    del big, scaled, occ, blurred, sharp, r, res, fine, coarse, w2, zones

    # (c) the volume programs at vol_n^3
    write_pdb(f("model.pdb"), synthetic_model(ANG_PDB_ATOMS, seed))
    run("from_pdb", "volume_from_pdb",
        ["-i", f("model.pdb"), "-o", f("pdb")] + list(VL_PDB))
    run("from_pdb_hs", "volume_from_pdb",
        ["-i", f("model.pdb"), "-o", f("pdb_hs"), "--high_sampling_rate", 1]
        + list(VL_PDB))
    q["from_pdb_sum"] = {"scattering": float(load("pdb.vol").sum()),
                         "high_sampling": float(load("pdb_hs.vol").sum())}
    v = phantom(vol_n, scaled_blobs(BLOBS8, vol_n))
    save_image(f("v.vol"), v)
    save_image(f("v_shifted.vol"), np.roll(v, VL_SHIFT, (0, 1, 2)))
    sh = []
    for name in ("v", "v_shifted"):
        prog = run(f"center_{name}", "volume_center",
                   ["-i", f(f"{name}.vol"), "-o", f(f"{name}_c.vol")])
        sh.append(np.array(prog.shift[::-1], np.float64))   # (z, y, x)
    q["volume_center_err_px"] = float(np.abs(sh[1] - sh[0]
                                             + np.array(VL_SHIFT)).max())
    rot, tilt, psi, sz, sy, sx = VL_ALIGN
    A = ProgVolumeAlign._trial_matrix(1.0, rot, tilt, psi, 1.0, sz, sy, sx)
    moved = apply_affine_3d(v, np.linalg.inv(A)[None, :3, :4].astype(
        np.float32), device=device)[0].cpu().numpy()
    save_image(f("v_moved.vol"), moved)
    for label, extra in (
            ("align_grid", list(VL_GRID)),
            ("align_local", ["--rot", rot - 5, "--tilt", tilt - 5,
                             "-y", sy + 1, "--local", "--dontScale"]),
            ("align_frm", ["--frm"])):
        prog = run(label, "volume_align",
                   ["--i1", f("v.vol"), "--i2", f("v_moved.vol")] + extra)
        q[label] = {"rotation_err_deg": rotation_angle_deg(prog.matrix_A, A),
                    "shift_err_px": float(np.abs(prog.matrix_A[:3, 3]
                                                 - A[:3, 3]).max())}
    blobs = scaled_blobs(BLOBS8, vol_n)
    removed = phantom(vol_n, blobs[VL_REMOVED:VL_REMOVED + 1])
    save_image(f("v_minus.vol"), phantom(vol_n, blobs[:VL_REMOVED]
                                         + blobs[VL_REMOVED + 1:]))
    run("subtraction", "volume_subtraction",
        ["--i1", f("v.vol"), "--i2", f("v_minus.vol"), "-o", f("diff.vol"),
         "--sub"])
    diff = load("diff.vol")
    region = removed > 0.05 * removed.max()
    q["subtraction_recovered"] = float((diff * removed)[region].sum()
                                       / (removed ** 2)[region].sum())
    q["subtraction_rest"] = float((diff[~region] ** 2).sum()
                                  / (v ** 2).sum())
    prog = run("segment", "volume_segment",
               ["-i", f("v.vol"), "-o", f("seg.vol")])
    seg = load("seg.vol")
    q["segment_mismatch"] = int((seg != (v >= prog.threshold)).sum())
    q["segment_mass"] = float(v[seg > 0.5].sum() / v.sum())
    run("mask", "transform_mask",
        ["-i", f("v.vol"), "-o", f("masked.vol"), "--mask", "circular", -20])
    cz = np.arange(vol_n, dtype=np.float32) - vol_n // 2
    r2 = (cz[:, None, None] ** 2 + cz[None, :, None] ** 2
          + cz[None, None, :] ** 2)
    q["mask_max_abs_diff"] = float(np.abs(
        load("masked.vol") - v * (np.sqrt(r2) <= vol_n // 2 - 20)).max())
    sym = c4_z_volume(vol_n)
    noisy_sym = (sym + VL_C4_NOISE * sym.std()
                 * np.random.default_rng(seed + 47).standard_normal(
                     sym.shape)).astype(np.float32)
    save_image(f("c4_noisy.vol"), noisy_sym)
    run("symmetrize", "transform_symmetrize",
        ["-i", f("c4_noisy.vol"), "-o", f("c4_sym.vol"), "--sym", "c4"])
    err = lambda w: float(np.sqrt(((w - sym) ** 2).mean()))
    q["symmetrize_err_ratio"] = err(load("c4_sym.vol")) / err(noisy_sym)
    prog = run("pseudoatoms", "volume_to_pseudoatoms",
               ["-i", f("v.vol"), "-o", f("atoms")] + list(VL_PSEUDO))
    q["pseudoatoms"] = {"final_error": prog.final_error,
                        "atoms": prog.n_placed,
                        "target": VL_PSEUDO[3] / 100.0}
    return q


def misc_and_volumes(seed, root: Path, classify: Path, clean4, poses4):
    """Phase 14 in root: the 18 programs of the micrograph, misc and volume
    slices through their CLI on the card, none of which may launch a
    kernel; the readings against the limits planned with
    tools/plan_volume_misc.py."""
    from xmipp3_tpu_torch.core import timing
    root.mkdir(parents=True)
    report = {}
    limit = Limits(14)

    def run(label, name, args):
        prog = run_program(14, report, label, name, args)
        check(not report[label]["launches"], f"phase 14 {label}: launched "
              f"{report[label]['launches']}")
        return prog

    start = time.perf_counter()
    timing.enable_timing(True)
    try:
        q = misc_volume_readings(seed, root, run, DEVICE, clean4, poses4,
                                 classify)
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["quality"] = q
    report["phase_s"] = time.perf_counter() - start
    for k in ("ref", "svm", "modes"):
        pk = q["pick_" + k] if k != "ref" else q["pick_ref"]
        limit(pk["recall"] >= PK_RECALL[k] and pk["precision"]
              >= PK_PRECISION[k], f"phase 14 pick_{k}: recall "
              f"{pk['recall']:.4f}, precision {pk['precision']:.4f} (limits "
              f"{PK_RECALL[k]}, {PK_PRECISION[k]})")
    limit(q["scissor_max_abs_diff"] == 0.0, "phase 14 scissor: "
          f"{q['scissor_max_abs_diff']} off the numpy crop")
    limit(q["noise_boxes"] == PK_VIEWS and q["noise_on_particles"] == 0,
          f"phase 14 --extractNoise: {q['noise_boxes']} boxes, "
          f"{q['noise_on_particles']} on a particle")
    limit(q["dimred_pca_vs_numpy_svd"] <= MISC_TOL, "phase 14 dimred PCA: "
          f"{q['dimred_pca_vs_numpy_svd']:.2e}")
    limit(q["dimred_corr_nearest_centroid"] >= MS_DIMRED_SEP,
          f"phase 14 dimred: {q['dimred_corr_nearest_centroid']:.4f}")
    limit(q["odd_even_max_abs_diff"] <= MISC_TOL, "phase 14 odd_even: "
          f"{q['odd_even_max_abs_diff']}")
    limit(q["distribution_count_diff"] == 0, "phase 14 distribution: "
          f"counts off by {q['distribution_count_diff']}")
    limit(q["grey_a_err"] <= MS_GREY_A and q["grey_b_err"] <= MS_GREY_B,
          f"phase 14 grey levels: a {q['grey_a_err']:.2e}, b "
          f"{q['grey_b_err']:.2e} (limits {MS_GREY_A}, {MS_GREY_B})")
    limit(q["center_image_err_px"] <= MS_CENTER_PX, "phase 14 "
          f"center_image: {q['center_image_err_px']:.3f} px")
    limit(q["morphology_diff_pixels"] == 0, "phase 14 morphology: "
          f"{q['morphology_diff_pixels']} pixels off scipy")
    limit(q["local_adjust_scale_err"] <= MS_ADJUST_TOL
          and q["local_adjust_out_err"] <= MS_ADJUST_TOL,
          f"phase 14 local_adjust: {q['local_adjust_scale_err']:.2e}, "
          f"{q['local_adjust_out_err']:.2e}")
    sh = q["sharpening"]
    limit(sh["finite"] and sh["tilt_fine"] > sh["tilt_coarse"],
          f"phase 14 sharpening: {sh}")
    for k, v in VL_PDB_SUM.items():
        limit(abs(q["from_pdb_sum"][k] - v) <= 1e-5 * abs(v),
              f"phase 14 from_pdb {k}: sum {q['from_pdb_sum'][k]} (plan "
              f"{v})")
    limit(q["volume_center_err_px"] <= VL_CENTER_PX, "phase 14 "
          f"volume_center: {q['volume_center_err_px']:.3f} px")
    for k in ("align_grid", "align_local", "align_frm"):
        limit(q[k]["rotation_err_deg"] <= VL_STEP
              and q[k]["shift_err_px"] <= 1.0, f"phase 14 {k}: {q[k]}")
    limit(q["subtraction_recovered"] >= VL_SUB_RECOVERED
          and q["subtraction_rest"] <= VL_SUB_REST,
          f"phase 14 subtraction: {q['subtraction_recovered']:.4f}, "
          f"{q['subtraction_rest']:.2e}")
    limit(q["segment_mismatch"] == 0 and q["segment_mass"]
          >= VL_SEGMENT_MASS, f"phase 14 segment: {q['segment_mismatch']}, "
          f"{q['segment_mass']:.4f}")
    limit(q["mask_max_abs_diff"] == 0.0, "phase 14 mask: "
          f"{q['mask_max_abs_diff']}")
    limit(q["symmetrize_err_ratio"] <= VL_SYM_RATIO, "phase 14 symmetrize: "
          f"{q['symmetrize_err_ratio']:.4f}")
    pa = q["pseudoatoms"]
    limit(pa["final_error"] <= pa["target"], f"phase 14 pseudoatoms: {pa}")
    log(f"  phase 14 took {report['phase_s']:.2f} s")
    log("misc " + json.dumps(report))
    limit.check()


# ---------------------------------------------------------------------------
# phase 15: Zernike3D and NMA flexibility
# ---------------------------------------------------------------------------

FX_L1, FX_L2 = 3, 2            # Zernike depths: 13 basis functions x 3
FX_VOL_COEFF = 1.5             # std of (a)'s planted coefficients
FX_PARTICLES = 16              # (b)'s views (planned on 16 at N=64)
FX_PART_COEFF = 0.6            # std of each view's planted coefficients
FX_JITTER = (1.5, 0.5)         # rows' angles (deg) and shifts (px) off the truth
FX_NOISE = 0.3                 # noise sigma, x the clean views' std
FX_TS = 2.0                    # A/px of (b)'s and (d)'s CTF views
FX_NMA_ATOMS = 300             # phase 12's synthetic model
FX_NMA_AMPS = (4.0, -3.0, 2.0)  # pdb_nma_deform's planted amplitudes (A)
FX_NMA_VIEWS = 8               # nma_alignment's views
FX_NMA_AMP = 4.0               # their amplitudes: uniform in +-FX_NMA_AMP
FX_NMA_STEP = 10.0             # --projMatch's --discrAngStep
FX_SUB_N = 64                  # (d)'s subtomograms
FX_SUBTOMOS = 8
FX_WEDGE = (-60.0, 60.0)       # their missing wedge (tilt range about y)
FX_ART_VIEWS = 400             # views of each of art_zernike3d's 2 states
# the mesh run against the serial one: Adam's normalised steps carry the
# float32 roundoff of other batch shapes and of the gather's atomic
# backward (1e-3 of the coefficients' max, 1e-2 degrees or px)
FX_MESH_TOL, FX_MESH_POSE = 1e-3, 1e-2
FX_APPLY_TOL = 1e-4            # the apply program against the script's warp
# limits: twice the shortfall of an NCC or correlation r (1 - 2 (1 - r)),
# twice an error, of what tools/plan_flex.py read of the reference on the
# CPU ((a) at 128^3, the rest at N=64; rounded outward). The per-particle
# coefficient errors near 1 are the reference's own: at these step counts
# it recovers little of each view's planted deformation (PERF.md §6)
FX_LIMITS = {
    "deform_ncc": 0.99966, "deform_field_err_px": 0.1517,
    "forward_volume_ncc": 0.99984,
    "sph": {"mean_cc": 0.9411, "coeff_err": 1.832, "pose_err_deg": 2.490},
    "fzi": {"mean_cc": 0.9432, "coeff_err": 1.972, "pose_err_deg": 2.442},
    "fzi_priors": {"mean_cc": 0.9432, "coeff_err": 2.094,
                   "pose_err_deg": 2.415},
    "nma_vol": {"amp_err": 0.6386, "ncc": 0.99497},
    "nma_alignment": {"amp_rms_err": 0.7454, "mean_cc": 0.98716},
    "nma_alignment_projmatch": {"amp_rms_err": 19.46, "mean_cc": 0.8348},
    "flexible_alignment": {"amp_rms_err": 0.7454, "mean_cc": 0.98716},
    "subtomos": {"mean_cc": 0.99869, "coeff_err": 1.474},
    "art_subtomos": {"corr": 0.98295}, "art_zernike3d": {"corr": 0.8380},
    "cuda11_forward_art_zernike3d": {"corr": 0.8411}}


def fx_coeff_err(got, want) -> float:
    """||got - want|| / ||want|| over every coefficient."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64).reshape(want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def fx_field_err(basis, c_got, c_want, weight) -> float:
    """The RMS, over the weight's mass, of the difference of two
    Zernike3D displacement fields (px; host numpy)."""
    dc = (np.asarray(c_got, np.float64).reshape(3, -1)
          - np.reshape(c_want, (3, -1)))
    d = np.einsum("ck,kzyx->czyx", dc.astype(np.float32), basis)
    w = np.asarray(weight, np.float64) / np.sum(weight)
    return float(np.sqrt((w * (d.astype(np.float64) ** 2).sum(0)).sum()))


def fx_angle_err(rows, rot, tilt, psi) -> float:
    """The median angle (degrees) between each row's rotation and the
    true one."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    col = lambda k: np.array([float(r[k]) for r in rows])
    A = np.asarray(euler_matrix(col("angleRot"), col("angleTilt"),
                                col("anglePsi")), np.float64)
    B = np.asarray(euler_matrix(rot, tilt, psi), np.float64)
    cos = (np.einsum("nij,nij->n", A, B) - 1) / 2
    return float(np.median(np.degrees(np.arccos(np.clip(cos, -1, 1)))))


def flex_readings(seed, root: Path, run, device, n: int = N,
                  vol_n: int = N, sub_n: int = FX_SUB_N,
                  particles: int = FX_PARTICLES,
                  art_views: int = FX_ART_VIEWS, mesh=None, nma_fit=None):
    """Phase 15's 16 programs on its recipes: run(label, program, args)
    runs one program (the port's on the card in this script, the
    reference's on the CPU in tools/plan_flex.py) and returns it; the data
    are made with the port's host functions and on `device`. (a) runs at
    vol_n^3, the rest at n. mesh(label, program, args) runs the --mesh dp
    twin of angular_sph_alignment (on the card only); nma_fit(vol_ref,
    vol_t, coords, modes, optimizer) runs the package's
    fit_mode_amplitudes. Returns (readings, the inputs of the phase's
    kernel checks)."""
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.pdb import (AtomicModel, rasterize, read_pdb,
                                           write_pdb)
    from xmipp3_tpu_torch.ops.forward_zernike import (forward_splat_volume,
                                                      masked_voxel_basis)
    from xmipp3_tpu_torch.ops.fourier_filter import wedge_mask_3d
    from xmipp3_tpu_torch.ops.project import FourierProjector
    from xmipp3_tpu_torch.ops.zernike import deform_volume, \
        zernike_basis_grid
    f = lambda name: str(root / name)
    load = lambda name: np.squeeze(Image(f(name)).data)
    rng = np.random.default_rng(seed + 31)
    q, extra = {}, {}
    col = lambda rows, k: np.stack([np.asarray(r[k], np.float64)
                                    for r in rows])

    # (a) Zernike3D on volumes at vol_n^3
    va = phantom(vol_n, scaled_blobs(BLOBS8, vol_n))
    save_image(f("vol_a.vol"), va)
    basis = zernike_basis_grid(vol_n, FX_L1, FX_L2)
    K = basis.shape[0]
    c_vol = rng.normal(0, FX_VOL_COEFF, (3, K)).astype(np.float32)
    deformed = deform_volume(va, basis, c_vol,
                             device=device).cpu().numpy()
    save_image(f("def.vol"), deformed)
    MetaData.fromRows([{"sphCoefficients": c_vol.ravel().astype(np.float64),
                        "image": f("vol_a.vol")}]).write(f("clnm.xmd"))
    q["deform_ncc0"] = real_corr(va, deformed)
    prog = run("volume_deform_sph", "volume_deform_sph", [
        "-i", f("vol_a.vol"), "-r", f("def.vol"), "-o", f("sph_fit.vol"),
        "--oroot", f("sph_fit"), "--analyzeStrain"])
    c_fit = col(MetaData(f("sph_fit.xmd")).iterRows(), "sphCoefficients")
    q["deform_ncc"] = float(prog.ncc)
    q["deform_field_err_px"] = fx_field_err(basis, c_fit, c_vol, va)
    q["deform_strain_finite"] = bool(
        np.isfinite(load("sph_fit_strain.vol")).all()
        and np.isfinite(load("sph_fit_rotation.vol")).all()
        and load("sph_fit_strain.vol").shape == (vol_n,) * 3)
    run("volume_apply_coefficient_zernike3d",
        "volume_apply_coefficient_zernike3d",
        ["-i", f("vol_a.vol"), "--clnm", f("clnm.xmd"), "-o", f("app.vol")])
    app = load("app.vol")
    q["apply_vs_warp"] = float(np.abs(app - deformed).max()
                               / np.abs(deformed).max())
    prog = run("forward_zernike_volume", "forward_zernike_volume", [
        "-i", f("vol_a.vol"), "-r", f("def.vol"), "-o", f("fwd.vol"),
        "--oroot", f("fwd")])
    q["forward_volume_ncc"] = float(prog.ncc)
    q["forward_volume_field_err_px"] = fx_field_err(
        basis, col(MetaData(f("fwd.xmd")).iterRows(), "sphCoefficients"),
        c_vol, va)
    del va, basis, deformed, app
    vol = phantom(n, scaled_blobs(BLOBS8, n))
    save_image(f("vol.vol"), vol)
    basis = zernike_basis_grid(n, FX_L1, FX_L2)

    # (b) per-particle fits on n^2 views of the phantom, each deformed by
    # its own planted coefficients, with CTFs, poses of phase 4's draw and
    # rows a little off
    P = particles
    p4, _ = cycle_poses(seed)
    rot, tilt, psi = (p4[k][:P].astype(np.float32)
                      for k in ("rot", "tilt", "psi"))
    c_part = rng.normal(0, FX_PART_COEFF, (P, 3, K)).astype(np.float32)
    dfu, dfv, az = ctf_recipe()
    views = np.empty((P, n, n), np.float32)
    for i in range(P):
        dv = deform_volume(vol, basis, c_part[i], device=device)
        proj = FourierProjector(dv, device=device).project_euler(
            rot[i:i + 1], tilt[i:i + 1], psi[i:i + 1])[0].cpu().numpy()
        g = i % len(dfu)
        views[i] = np.fft.irfft2(np.fft.rfft2(proj) * plant_ctf(
            n, FX_TS, dfu[g], dfv[g], az[g]), s=(n, n))
    views += rng.normal(0, FX_NOISE * views.std(), views.shape).astype(
        np.float32)
    save_image(f("views.mrcs"), views)
    ja, js = FX_JITTER
    jit = rng.uniform(-1, 1, (P, 5)) * [ja, ja, ja, js, js]
    MetaData.fromRows({
        "image": f"{i + 1}@{f('views.mrcs')}", "itemId": i + 1,
        "angleRot": float(rot[i] + jit[i, 0]),
        "angleTilt": float(tilt[i] + jit[i, 1]),
        "anglePsi": float(psi[i] + jit[i, 2]), "shiftX": float(jit[i, 3]),
        "shiftY": float(jit[i, 4]), "ctfVoltage": CTF_KV,
        "ctfSphericalAberration": CTF_CS, "ctfQ0": CTF_Q0,
        "ctfDefocusU": float(dfu[i % len(dfu)]),
        "ctfDefocusV": float(dfv[i % len(dfu)]),
        "ctfDefocusAngle": float(az[i % len(dfu)])}
        for i in range(P)).write(f("views.xmd"))
    rows0 = list(MetaData(f("views.xmd")).iterRows())
    q["pose_err0_deg"] = fx_angle_err(rows0, rot, tilt, psi)
    part_args = ["-i", f("views.xmd"), "--ref", f("vol.vol"), "--sampling",
                 FX_TS, "--optimizeAlignment", "--optimizeDeformation"]

    def particle_readings(label, fn):
        rows = list(MetaData(f(fn)).iterRows())
        q[label] = {"mean_cc": float(np.mean(col(rows, "maxCC"))),
                    "coeff_err": fx_coeff_err(
                        col(rows, "sphCoefficients"), c_part),
                    "pose_err_deg": fx_angle_err(rows, rot, tilt, psi)}
        return rows

    run("angular_sph_alignment", "angular_sph_alignment",
        part_args + ["-o", f("sph.xmd")])
    serial = particle_readings("sph", "sph.xmd")
    if mesh is not None:
        mesh("angular_sph_alignment_mesh", "angular_sph_alignment",
             part_args + ["-o", f("sph_mesh.xmd")])
        meshed = list(MetaData(f("sph_mesh.xmd")).iterRows())
        cs_, cm = (col(r, "sphCoefficients") for r in (serial, meshed))
        q["sph_mesh_vs_serial"] = {
            "coeff": float(np.abs(cm - cs_).max() / np.abs(cs_).max()),
            "pose": max(float(np.abs(col(meshed, k) - col(serial, k)).max())
                        for k in ("angleRot", "angleTilt", "anglePsi",
                                  "shiftX", "shiftY")),
            "images_equal": [r["image"] for r in meshed]
            == [r["image"] for r in serial]}
    run("forward_zernike_images", "forward_zernike_images",
        part_args + ["--useCTF", "-o", f("fzi.xmd")])
    particle_readings("fzi", "fzi.xmd")
    run("forward_zernike_images_priors", "forward_zernike_images_priors", [
        "-i", f("fzi.xmd"), "--ref", f("vol.vol"), "--sampling", FX_TS,
        "--useCTF", "--optimizeAlignment", "--optimizeDeformation", "-o",
        f("fzip.xmd")])
    particle_readings("fzi_priors", "fzip.xmd")

    # (c) NMA of phase 12's synthetic model (centred) at 1 A/px
    model = synthetic_model(FX_NMA_ATOMS, seed).centered()
    write_pdb(f("m.pdb"), model)
    run("nma_modes", "nma_modes", ["-i", f("m.pdb"), "--oroot", f("nm"),
                                   "--nmodes", len(FX_NMA_AMPS)])
    modes = np.stack([np.loadtxt(f(f"nm_mode{m + 1:03d}.mod"))
                      for m in range(len(FX_NMA_AMPS))]).astype(np.float32)
    with open(f("modes.txt"), "w") as fh:
        fh.write("\n".join(f(f"nm_mode{m + 1:03d}.mod")
                           for m in range(len(modes))))
    run("pdb_nma_deform", "pdb_nma_deform", [
        "--pdb", f("m.pdb"), "-o", f("def.pdb"), "--nma", f("nm_modes.xmd"),
        "--deformations", *FX_NMA_AMPS])
    moved = read_pdb(f("def.pdb"))
    # the written model (coordinates to 1e-3 A) moved by the plant: the
    # output's own rounding is left, up to 5e-4 A
    want = read_pdb(f("m.pdb")).coords + np.einsum(
        "m,mnk->nk", FX_NMA_AMPS, modes)
    q["pdb_deform_err_A"] = float(np.abs(moved.coords - want).max())
    vol_t = rasterize(moved, n, 1.0, sigma_a=2.0)
    save_image(f("nma_t.vol"), vol_t)
    prog = run("nma_alignment_vol", "nma_alignment_vol", [
        "-i", f("nma_t.vol"), "--pdb", f("m.pdb"), "--modes",
        f("nm_modes.xmd"), "-o", f("nma_vol.xmd")])
    q["nma_vol"] = {"amp_err": float(np.abs(np.asarray(prog.amplitudes)
                                            - FX_NMA_AMPS).max()),
                    "ncc": float(prog.ncc)}
    if nma_fit is not None:
        vol_r = rasterize(model, n, 1.0, sigma_a=2.0)
        for opt in ("adam", "trust"):
            amp, ncc = nma_fit(vol_r, vol_t, model.coords, modes, opt)
            q[f"nma_fit_{opt}"] = {
                "amp_err": float(np.abs(np.asarray(amp)
                                        - FX_NMA_AMPS).max()),
                "ncc": float(ncc)}
    V = FX_NMA_VIEWS
    amps = rng.uniform(-FX_NMA_AMP, FX_NMA_AMP, (V, len(modes)))
    nr, nt, npsi = (p4[k][P:P + V].astype(np.float32)
                    for k in ("rot", "tilt", "psi"))
    nviews = np.stack([FourierProjector(rasterize(AtomicModel(
        model.coords + np.einsum("m,mnk->nk", amps[i], modes),
        model.elements, model.bfactors, model.occupancies), n, 1.0),
        device=device).project_euler(nr[i:i + 1], nt[i:i + 1],
                                     npsi[i:i + 1])[0].cpu().numpy()
        for i in range(V)])
    nviews += rng.normal(0, 0.1 * nviews.std(), nviews.shape).astype(
        np.float32)
    save_image(f("nma_views.mrcs"), nviews)
    nj = rng.uniform(-1, 1, (V, 3)) * 2.0
    MetaData.fromRows({
        "image": f"{i + 1}@{f('nma_views.mrcs')}", "itemId": i + 1,
        "angleRot": float(nr[i] + nj[i, 0]),
        "angleTilt": float(nt[i] + nj[i, 1]),
        "anglePsi": float(npsi[i] + nj[i, 2])}
        for i in range(V)).write(f("nma_views.xmd"))
    nma_args = ["-i", f("nma_views.xmd"), "--pdb", f("m.pdb"), "--modes",
                f("modes.txt")]
    for label, name, flags in (
            ("nma_alignment", "nma_alignment", []),
            ("nma_alignment_projmatch", "nma_alignment",
             ["--projMatch", "--discrAngStep", FX_NMA_STEP]),
            ("flexible_alignment", "flexible_alignment", [])):
        run(label, name, nma_args + flags + ["-o", f(f"{label}.xmd")])
        rows = list(MetaData(f(f"{label}.xmd")).iterRows())
        q[label] = {
            "amp_rms_err": float(np.sqrt(np.mean(
                (col(rows, "nmaDisplacements") - amps) ** 2))),
            "mean_cc": float(np.mean(col(rows, "maxCC"))),
            "pose_err_deg": fx_angle_err(rows, nr, nt, npsi)}
    extra["nma"] = (rasterize(model, n, 1.0), nviews)

    # (d) subtomograms at sub_n^3 and ART of two states at n^2
    vs = phantom(sub_n, scaled_blobs(BLOBS8, sub_n))
    save_image(f("sub_ref.vol"), vs)
    cloud = masked_voxel_basis(vs, FX_L1, FX_L2,
                               value_threshold=float(vs.max()) * 1e-3)
    wedge = wedge_mask_3d(sub_n, sub_n, sub_n, *FX_WEDGE)

    def subtomos(fn, coeffs, n_sub, extra_row):
        ang = [rng.uniform(0, 360, n_sub), np.degrees(np.arccos(
            rng.uniform(-1, 1, n_sub))), rng.uniform(0, 360, n_sub)]
        ang = [a.astype(np.float32) for a in ang]
        vols = forward_splat_volume(*cloud, coeffs, *ang, sub_n,
                                    device=device)[0].cpu().numpy()
        vols = np.fft.irfftn(np.fft.rfftn(vols, axes=(1, 2, 3)) * wedge,
                             s=(sub_n,) * 3, axes=(1, 2, 3))
        rows = []
        for i in range(n_sub):
            save_image(f(f"{fn}{i:02d}.vol"), vols[i].astype(np.float32))
            rows.append(dict(extra_row(i), image=f(f"{fn}{i:02d}.vol"),
                             itemId=i + 1, angleRot=float(ang[0][i]),
                             angleTilt=float(ang[1][i]),
                             anglePsi=float(ang[2][i]), shiftX=0.0,
                             shiftY=0.0, shiftZ=0.0))
        MetaData.fromRows(rows).write(f(f"{fn}.xmd"))

    c_sub = rng.normal(0, FX_PART_COEFF, (FX_SUBTOMOS, 3, K)).astype(
        np.float32)
    subtomos("sub", c_sub, FX_SUBTOMOS, lambda i: {})
    run("forward_zernike_subtomos", "forward_zernike_subtomos", [
        "-i", f("sub.xmd"), "--ref", f("sub_ref.vol"), "-o", f("fzs.xmd"),
        "--t1", FX_WEDGE[0], "--t2", FX_WEDGE[1]])
    rows = list(MetaData(f("fzs.xmd")).iterRows())
    q["subtomos"] = {"mean_cc": float(np.mean(col(rows, "maxCC"))),
                     "coeff_err": fx_coeff_err(
                         col(rows, "sphCoefficients"), c_sub)}
    c_two = rng.normal(0, FX_PART_COEFF, (3, K)).astype(np.float32)
    state = lambda i: c_two * (1 if i % 2 == 0 else -1)
    subtomos("artsub", np.stack([state(i) for i in range(FX_SUBTOMOS)]),
             FX_SUBTOMOS, lambda i: {"sphCoefficients": state(i).ravel()
                                     .astype(np.float64)})
    prog = run("forward_art_zernike3d_subtomos",
               "forward_art_zernike3d_subtomos", [
                   "-i", f("artsub.xmd"), "-o", f("artsub.vol"),
                   "--useZernike", "--clusters", 2, "--t1", FX_WEDGE[0],
                   "--t2", FX_WEDGE[1]])
    lab = np.asarray(prog.labels)
    q["art_subtomos"] = {"corr": real_corr(load("artsub.vol"), vs),
                         "states_split": bool(
                             len(set(lab[0::2])) == 1
                             and len(set(lab[1::2])) == 1
                             and lab[0] != lab[1])}
    # two states of the n^3 phantom (+-c, a view a state in turn), views at
    # uniform directions with CTFs, rows carrying their state's coefficients
    c_art = rng.normal(0, FX_VOL_COEFF / 2, (3, K)).astype(np.float32)
    A = 2 * art_views
    ang = [rng.uniform(0, 360, A), np.degrees(np.arccos(
        rng.uniform(-1, 1, A))), rng.uniform(0, 360, A)]
    ang = [a.astype(np.float32) for a in ang]
    aviews = np.empty((A, n, n), np.float32)
    for s, sign in enumerate((1, -1)):
        sel = np.arange(s, A, 2)
        dv = deform_volume(vol, basis, sign * c_art, device=device)
        aviews[sel] = FourierProjector(dv, device=device).project_euler(
            *(a[sel] for a in ang)).cpu().numpy()
    groups = np.arange(A) % len(dfu)
    for g in range(len(dfu)):
        sel = groups == g
        aviews[sel] = np.fft.irfft2(np.fft.rfft2(aviews[sel]) * plant_ctf(
            n, FX_TS, dfu[g], dfv[g], az[g]), s=(n, n))
    aviews += rng.normal(0, FX_NOISE * aviews.std(), aviews.shape).astype(
        np.float32)
    save_image(f("art.mrcs"), aviews)
    MetaData.fromRows({
        "image": f"{i + 1}@{f('art.mrcs')}", "itemId": i + 1,
        "angleRot": float(ang[0][i]), "angleTilt": float(ang[1][i]),
        "anglePsi": float(ang[2][i]), "ctfVoltage": CTF_KV,
        "ctfSphericalAberration": CTF_CS, "ctfQ0": CTF_Q0,
        "ctfDefocusU": float(dfu[groups[i]]),
        "ctfDefocusV": float(dfv[groups[i]]),
        "ctfDefocusAngle": float(az[groups[i]]),
        "sphCoefficients": (c_art * (1 if i % 2 == 0 else -1)).ravel()
        .astype(np.float64)} for i in range(A)).write(f("art.xmd"))
    art_args = ["-i", f("art.xmd"), "--useZernike", "--useCTF",
                "--sampling", FX_TS, "--clusters", 2]
    for label, flags in (("art_zernike3d", []),
                         ("cuda11_forward_art_zernike3d",
                          ["--ltk", 1e-4, "--ltv", 1e-4])):
        prog = run(label, label, art_args + flags + ["-o", f(f"{label}.vol")])
        lab = np.asarray(prog.labels)
        q[label] = {"corr": real_corr(load(f"{label}.vol"), vol),
                    "states_split": bool(
                        len(set(lab[0::2])) == 1 and len(set(lab[1::2])) == 1
                        and lab[0] != lab[1])}
    extra["art_cluster_poses"] = [a[0::2] for a in ang]
    return q, extra


def cross_at_trial_shape(name, refs, imgs, max_shift: int = 8):
    """K4 against its plain version at one trial of match_to_gallery's
    scan at its defaults (nma_alignment --projMatch's: the views against
    the --discrAngStep gallery, 31 rings, 64 harmonics, with the mirror);
    timed beside the plain version and two complex einsums."""
    import torch
    from xmipp3_tpu_torch.ops import cross
    from xmipp3_tpu_torch.ops.match import (_masked_spectra, _prepare,
                                            _ring_weights, _trial_spectra)
    refs, imgs, radius_max, trials = _prepare(refs, imgs, max_shift, None,
                                              None, DEVICE)
    f_refs, f_all = _trial_spectra(refs, imgs, trials, 2, radius_max, 2, 64)
    w = _ring_weights(f_refs.shape[1], 2, refs.device)
    fi, fr, _ = _masked_spectra(f_refs, f_all[0].contiguous(), w)
    B, nr, K = fi.shape
    R = fr.shape[0]
    log(f"{name} at B={B}, nr={nr}, R={R}, k={K}, with the "
        f"mirror ({len(trials)} trials a scan)")
    got = cross.cross_spectrum(fi, fr, w, mirror=True)
    want = cross.cross_spectrum_plain(fi, fr, w, mirror=True)
    torch.cuda.synchronize()
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    rel = err / max(float(p.abs().max()) for p in want)
    log(f"  {name}: max|kernel-plain| = {err:.3e}, / max|plain| = {rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL_CROSS,
          f"{name}: kernel disagrees with its plain version ({rel:.3e} > "
          f"{TOL_CROSS})")
    del got, want
    ms = time_ms(lambda: cross.cross_spectrum(fi, fr, w, mirror=True),
                 reps=20)
    plain_ms = time_ms(lambda: cross.cross_spectrum_plain(fi, fr, w, True),
                       reps=5, warmup=1)
    wi = w[None, :, None]
    library_ms = time_ms(lambda: (
        torch.einsum("brk,Rrk->bRk", fi * wi, fr.conj()),
        torch.einsum("brk,Rrk->bRk", fi.conj() * wi, fr.conj())), reps=5,
        warmup=1)
    nbytes = 8 * (B + R) * nr * K + 4 * nr + 2 * 8 * B * R * K
    nops = 8 * B * nr * R * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, two complex einsums "
        f"{library_ms:.4f} ms); bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.4f} GFLOP "
        f"-> {t_ops:.4f} ms)")
    src, replaces = KERNELS["cross_spectrum"]
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "max_abs_err": err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": [B, nr, R, K]}


def flexibility(seed, root: Path):
    """Phase 15 in root: the 16 programs of the Zernike3D and NMA slice
    through their CLI on the card (angular_sph_alignment also with --mesh
    dp over 2 gloo ranks); only art_zernike3d and
    cuda11_forward_art_zernike3d (K3, a launch for each cluster's start and
    each SIRT iteration) and nma_alignment --projMatch (K4) may launch a
    kernel. K3 is held against its plain version at one art_zernike3d pass
    (a cluster's views), K4 at one trial of --projMatch's scan. Returns
    the two kernels' entries."""
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.sampling import compute_sampling_points
    from xmipp3_tpu_torch.models.nma import fit_mode_amplitudes
    from xmipp3_tpu_torch.ops.project import FourierProjector
    root.mkdir(parents=True)
    report = {}
    limit = Limits(15)
    kernel_of = {"art_zernike3d": "kb_scatter_3ch",
                 "cuda11_forward_art_zernike3d": "kb_scatter_3ch",
                 "nma_alignment_projmatch": "cross_spectrum"}

    def run(label, name, args):
        prog = run_program(15, report, label, name, args)
        got = report[label]["launches"]
        want = kernel_of.get(label)
        check(set(got) == ({want} if want else set()),
              f"phase 15 {label}: launched {got}, expected "
              f"{want or 'no kernel'}")
        return prog

    def mesh(label, name, args):
        for r, rep in enumerate(run_mesh(report, root, label, name, args)):
            got = {k: v for k, v in rep["launches"].items() if v}
            check(not got, f"phase 15 {label} rank {r}: launched {got}")

    def nma_fit(vol_r, vol_t, coords, modes, optimizer):
        return fit_mode_amplitudes(vol_r, vol_t, coords, modes,
                                   optimizer=optimizer, device=DEVICE)

    start = time.perf_counter()
    timing.enable_timing(True)
    try:
        q, extra = flex_readings(seed, root, run, DEVICE, mesh=mesh,
                                 nma_fit=nma_fit)
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["quality"] = q
    report["phase_s"] = time.perf_counter() - start
    # one art_zernike3d pass: a cluster's views gridded with K3
    k3 = grid_at_views("kb_scatter_3ch_art_zernike3d", "kb",
                       *extra["art_cluster_poses"], seed, reps=10,
                       phase=15)
    k3["launches"] = sum(report[k]["launches"]["kb_scatter_3ch"] for k in
                         ("art_zernike3d", "cuda11_forward_art_zernike3d"))
    vol_nma, nviews = extra["nma"]
    ang = compute_sampling_points(FX_NMA_STEP)
    gallery = FourierProjector(vol_nma, device=DEVICE).project_euler(
        ang[:, 0].astype(np.float32), ang[:, 1].astype(np.float32),
        np.zeros(len(ang), np.float32))
    k4 = cross_at_trial_shape("cross_spectrum_nma_projmatch", gallery,
                              nviews)
    k4["launches"] = report["nma_alignment_projmatch"]["launches"][
        "cross_spectrum"]
    report["kernels"] = {k["name"]: {x: k[x] for x in (
        "ms", "plain_ms", "bound_ms", "library_ms", "launches")}
        for k in (k3, k4)}
    log(f"  phase 15 took {report['phase_s']:.2f} s")
    log("flex " + json.dumps(report))
    L = FX_LIMITS
    limit(q["deform_ncc"] >= L["deform_ncc"], f"phase 15 volume_deform_sph: "
          f"NCC {q['deform_ncc']:.5f} (limit {L['deform_ncc']})")
    limit(q["deform_field_err_px"] <= L["deform_field_err_px"],
          f"phase 15 volume_deform_sph: field error "
          f"{q['deform_field_err_px']:.4f} px")
    limit(q["deform_strain_finite"], "phase 15 --analyzeStrain: not finite")
    limit(q["apply_vs_warp"] <= FX_APPLY_TOL, "phase 15 apply: "
          f"{q['apply_vs_warp']:.2e} off the script's warp")
    limit(q["forward_volume_ncc"] >= L["forward_volume_ncc"],
          f"phase 15 forward_zernike_volume: NCC "
          f"{q['forward_volume_ncc']:.5f}")
    for k in ("sph", "fzi", "fzi_priors"):
        limit(q[k]["mean_cc"] >= L[k]["mean_cc"]
              and q[k]["coeff_err"] <= L[k]["coeff_err"]
              and q[k]["pose_err_deg"] <= L[k]["pose_err_deg"],
              f"phase 15 {k}: {q[k]} (limits {L[k]})")
    m = q["sph_mesh_vs_serial"]
    limit(m["images_equal"] and m["coeff"] <= FX_MESH_TOL
          and m["pose"] <= FX_MESH_POSE, f"phase 15 mesh: {m}")
    limit(q["pdb_deform_err_A"] <= 1e-3, "phase 15 pdb_nma_deform: "
          f"{q['pdb_deform_err_A']:.2e} A off the planted displacement")
    for k in ("nma_vol", "nma_fit_adam", "nma_fit_trust"):
        limit(q[k]["amp_err"] <= L["nma_vol"]["amp_err"]
              and q[k]["ncc"] >= L["nma_vol"]["ncc"],
              f"phase 15 {k}: {q[k]} (limits {L['nma_vol']})")
    for k in ("nma_alignment", "nma_alignment_projmatch",
              "flexible_alignment"):
        limit(q[k]["amp_rms_err"] <= L[k]["amp_rms_err"]
              and q[k]["mean_cc"] >= L[k]["mean_cc"],
              f"phase 15 {k}: {q[k]} (limits {L[k]})")
    limit(q["subtomos"]["mean_cc"] >= L["subtomos"]["mean_cc"]
          and q["subtomos"]["coeff_err"] <= L["subtomos"]["coeff_err"],
          f"phase 15 subtomos: {q['subtomos']} (limits {L['subtomos']})")
    for k in ("art_subtomos", "art_zernike3d",
              "cuda11_forward_art_zernike3d"):
        limit(q[k]["states_split"] and q[k]["corr"] >= L[k]["corr"],
              f"phase 15 {k}: {q[k]} (limits {L[k]})")
    limit.check()
    return [k3, k4]


# ---------------------------------------------------------------------------
# phase 16: tomography, the tail of flex_misc_ext and three tilt programs
# ---------------------------------------------------------------------------

TM_SIZE, TM_Z, TM_BOX = 512, 128, 64   # tomogram X = Y, thickness; particle box
TM_TILTS = (-60.0, 60.0, 3.0)          # 41 tilt images
TM_PARTICLES = 40                      # half of each state
TM_FIDUCIALS = 12
TM_TS = 8.0                            # A/px: a K2/K3 series binned to 512^2
TM_FID_A = 80.0                        # gold bead diameter (A): 10 px
TM_NOISE = 4.0                         # the simulator's --sigmaNoise
TM_DOSE = 3.0                          # e/A^2 per tilt image
TM_CTF_DEFOCUS = (30000.0, 45000.0)    # A: the planted CTFs' span over the tilts
TM_WITHIN = 3.0                        # px: a landmark this close is a hit
TM_LOWPASS = 0.1                       # cycles/px: the tomogram's correlation
TM_FILTER_RADIUS = 25                  # --radius (the reference's ball: r2 <= it)
TM_SUBTRACT = 4                        # subtomograms through subtomo_subtraction
TM_SUB_N, TM_SUBTOMOS = 64, 1000       # classify_CLTomo_prog's set
TM_SUB_SHIFT, TM_SUB_NOISE = 2, 1.0    # voxels; x the states' std
TM_FTTRI_VIEWS = 2048                  # of phase 10's recipe
TM_ANNEAL_VIEWS = 1000                 # of phase 4's views
TM_PAIRS, TM_PAIR_TILT = 200, 45.0     # tilt-pair positions, degrees
TM_PAIR_SHIFT = 3.0                    # px: planted shifts of the tilted views
TM_TRANSFORM = (30.0, 20.0, 10.0)      # phantom_transform rotate_euler
TM_TOL = 1e-4                          # numpy checks
TM_MD_TOL = 1e-5                       # host numbers read back from metadata
# limits: what tools/plan_tomo.py read of the reference on the CPU (the
# tomogram at 256 x 256 x 96 with 8 particles, the rest at N=64): twice
# the shortfall of a correlation, recall, precision or share r, or half
# of r where that is higher; half the directions won; twice an error;
# rounded inward
TM_LIMITS = {
    "landmarks": {"recall": 0.7805, "precision": 0.2684},
    "beads_truth": {"recall": 1.0, "precision": 0.0572},
    "pairs": {"recall": 1.0, "precision": 1.0},
    "residuals_rms_px": 2.0816, "misalignment_enabled": 0.7561,
    "tomogram_corr": 0.4826,
    "average_corr": 0.2018, "map_back_mass": 1.072e-5,
    "subtraction_energy": 0.001234, "cltomo_purity": 1.0,
    "fttri_purity": 0.1705, "fttri_won": 6, "anneal_corr": 0.2645,
    "align_pairs": {"enabled": 1.0, "shift_err_px": 1.3006}}
# what the reference's tomo_detect_missing_wedge and
# image_peak_high_contrast read on the card's reconstruction (tools/
# plan_tomo.py --tomogram, on tools/phase_alone.py 16 --keep's float16
# copy; the port on the CPU read the same): the planes' (rot, tilt) and
# the beads' (x, y, z). With numpy's noise of 1e-3 of its std added the
# port read the same beads and the first plane's normal 0.37 degrees off:
# twice that, and the same beads within a voxel
TM_REF_WEDGE_PLANES = ((180.0, -89.9537037037), (270.0, 90.0))
TM_WEDGE_PLANE_TOL = 0.74
TM_REF_BEADS = ((45, 474, 43), (181, 46, 48), (105, 402, 53), (406, 106, 58),
                (113, 102, 69), (462, 409, 69), (473, 337, 70), (458, 326, 72),
                (179, 39, 76), (37, 402, 88), (22, 110, 96), (45, 47, 105))


def tomo_geometry(seed: int, size: int, thickness: int, box: int,
                  particles: int, fiducials: int, fid_px: int):
    """The planted particles (x, y, z centred voxels; rot, tilt, psi; state
    0/1) on a jittered grid of cells a box and an eighth apart, and the
    fiducials (x, y, z) between its cells (numpy's draws)."""
    rng = np.random.default_rng(seed + 41)
    lim = size // 2 - box // 2 - box // 8
    g = np.linspace(-lim, lim, int(2 * lim // (box + box // 8)) + 1)
    gx = gy = g
    cells = np.array([(x, y) for y in gy for x in gx])
    check(len(cells) >= particles, f"phase 16: {len(cells)} cells for "
          f"{particles} particles")
    pick = rng.permutation(len(cells))[:particles]
    xy = np.rint(cells[pick] + rng.uniform(-box / 16, box / 16,
                                           (particles, 2))).astype(int)
    zlim = thickness // 2 - box // 2 - 2
    z = rng.integers(-zlim, zlim + 1, particles)
    ang = np.stack([rng.uniform(0, 360, particles),
                    np.degrees(np.arccos(rng.uniform(-1, 1, particles))),
                    rng.uniform(0, 360, particles)], axis=1)
    state = np.arange(particles) % 2
    mid = np.array([((a + b) / 2, (c + d) / 2)
                    for a, b in zip(gx[:-1], gx[1:])
                    for c, d in zip(gy[:-1], gy[1:])])
    fxy = np.rint(mid[rng.permutation(len(mid))[:fiducials]]).astype(int)
    fz = rng.integers(-(thickness // 2 - fid_px), thickness // 2 - fid_px + 1,
                      len(fxy))
    return (np.column_stack([xy, z]), ang, state,
            np.column_stack([fxy, fz]))


def tilt_pair_coordinates(seed: int, n: int, tilt: float, size: float = 4096):
    """n untilted positions in a size^2 micrograph and their tilted
    partners (x compressed by cos(tilt), rotated 10 degrees, shifted, 0.5
    px of noise), with 10 % spare points on each side; returns (u, t,
    truth: t's index of each u, -1 for a spare)."""
    rng = np.random.default_rng(seed + 43)
    u = rng.uniform(0.05 * size, 0.95 * size, (n, 2))
    a = np.deg2rad(10.0)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    A = R @ np.diag([np.cos(np.deg2rad(tilt)), 1.0])
    t = u @ A.T + [0.2 * size, 0.05 * size] + rng.normal(0, 0.5, (n, 2))
    spare = n // 10
    u = np.concatenate([u, rng.uniform(0.05 * size, 0.95 * size,
                                       (spare, 2))])
    t = np.concatenate([t, rng.uniform(0.05 * size, 0.95 * size,
                                       (spare, 2))])
    order = rng.permutation(len(t))
    inv = np.argsort(order)
    truth = np.concatenate([inv[:n], -np.ones(spare, int)])
    return u, t[order], truth


def hits(found, planted, within: float):
    """(recall: the share of planted points with a found one within
    `within`, precision: the share of found points with a planted one)."""
    from scipy.spatial import cKDTree
    found = np.asarray(found, np.float64).reshape(-1, planted.shape[1])
    if not len(found):
        return 0.0, 0.0
    recall = float((cKDTree(found).query(planted)[0] <= within).mean())
    precision = float((cKDTree(planted).query(found)[0] <= within).mean())
    return recall, precision


def zyz64(rot: float, tilt: float, psi: float):
    """The ZYZ Euler matrix of angles in degrees, in float64 numpy
    (core.geometry's formula, written out here)."""
    a, b, g = np.deg2rad([rot, tilt, psi])
    c1, s1, c2, s2, c3, s3 = (np.cos(a), np.sin(a), np.cos(b), np.sin(b),
                              np.cos(g), np.sin(g))
    return np.array([
        [c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1, -c3 * s2],
        [-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1, s3 * s2],
        [s2 * c1, s2 * s1, c2]])


def lowpass_nd(vol, cutoff: float):
    """vol (any 3-D shape) without the frequencies above `cutoff`."""
    f = [np.fft.fftfreq(n) for n in vol.shape[:-1]] + \
        [np.fft.rfftfreq(vol.shape[-1])]
    r2 = sum(np.reshape(a, [-1 if i == k else 1 for i in range(3)]) ** 2
             for k, a in enumerate(f))
    return np.fft.irfftn(np.fft.rfftn(vol) * (r2 <= cutoff * cutoff),
                         s=vol.shape, axes=(0, 1, 2))


def bead_readings(run, label, tomogram: str, fiducials, fid_px: int):
    """image_peak_high_contrast on the tomogram (z, y, x in the
    simulator's frame): the beads found, and their recall and precision
    against the fiducials (x, y, z voxel indices) within a bead's
    diameter."""
    out = str(Path(tomogram).with_name(f"{label}.xmd"))
    run(label, "image_peak_high_contrast", [
        "--vol", tomogram, "-o", out, "--samplingRate", TM_TS,
        "--fiducialSize", TM_FID_A, "--boxSize", 4 * fid_px])
    beads = [(b["xcoor"], b["ycoor"], b["zcoor"]) for b in md_rows(out)]
    rec_, prec_ = hits(beads, np.asarray(fiducials, np.float64), fid_px)
    return {"found": len(beads), "recall": rec_, "precision": prec_,
            "xyz": [[int(a) for a in b] for b in beads]}


def wedge_and_beads(run, tomogram: str, fiducials, fid_px: int) -> dict:
    """tomo_detect_missing_wedge (its wedge and both planes' rot, tilt)
    and bead_readings on the tomogram."""
    prog = run("wedge", "tomo_detect_missing_wedge", ["-i", tomogram])
    return {"wedge": [float(v) for v in prog.wedge],
            "wedge_planes": [[float(a) for a in p] for p in prog.planes],
            "beads": bead_readings(run, "beads", tomogram, fiducials,
                                   fid_px)}


def plane_angle(a, b) -> float:
    """Degrees between two planes through the origin given as (rot,
    tilt): their normals' angle, either sign."""
    n = [np.array([np.sin(t) * np.cos(r), np.sin(t) * np.sin(r), np.cos(t)])
         for r, t in np.deg2rad([a, b])]
    return float(np.degrees(np.arccos(min(abs(n[0] @ n[1]), 1.0))))


def tomo_readings(seed, root: Path, run, device, size: int = TM_SIZE,
                  thickness: int = TM_Z, box: int = TM_BOX,
                  particles: int = TM_PARTICLES, sub_n: int = TM_SUB_N,
                  subtomos: int = TM_SUBTOMOS,
                  fttri_views: int = TM_FTTRI_VIEWS, n: int = N,
                  anneal_views: int = TM_ANNEAL_VIEWS, mesh=None):
    """Phase 16's 28 programs on its recipes: run(label, program, args)
    runs one program (the port's on the card in this script, the
    reference's on the CPU in tools/plan_tomo.py) and returns it; the data
    are made with numpy and the port's host functions, the views on
    `device`. (a) runs at size x size x thickness with particles of
    box^3, (b) CLTomo at sub_n^3 and FTTRI and (c), (d) at n. mesh(label,
    program, args) runs classify_FTTRI's --mesh dp twin (on the card
    only). Returns (quality readings, what the kernels' checks need)."""
    import torch
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.pdb import write_pdb
    from xmipp3_tpu_torch.core.sampling import compute_sampling_points
    from xmipp3_tpu_torch.ops.geo import apply_affine_2d
    from xmipp3_tpu_torch.ops.project import FourierProjector
    f = lambda name: str(root / name)
    load = lambda name: np.squeeze(Image(f(name)).data)
    stack = lambda name: np.asarray(Image.read_stack(f(name)))
    q, extra = {}, {}

    def rows_of(name):
        return md_rows(f(name))

    # (a) a tomogram and its tilt series
    t0 = time.perf_counter()
    fid_px = max(int(round(TM_FID_A / TM_TS)), 3)
    tilts = np.arange(TM_TILTS[0], TM_TILTS[1] + 1e-6, TM_TILTS[2])
    pos, ang, state, fid = tomo_geometry(seed, size, thickness, box,
                                         particles, TM_FIDUCIALS, fid_px)
    states = analysis_states(box)
    parts = [phantom(box, b) for b in states]
    for k, v in enumerate(parts):
        save_image(f(f"part{k}.vol"), v)
    for k in (0, 1):
        sel = state == k
        MetaData.fromRows(
            {"xcoor": int(x), "ycoor": int(y), "zcoor": int(z),
             "angleRot": float(a[0]), "angleTilt": float(a[1]),
             "anglePsi": float(a[2])} for (x, y, z), a in
            zip(pos[sel], ang[sel])).write(f(f"coords{k}.xmd"))
    MetaData.fromRows({"xcoor": int(x), "ycoor": int(y), "zcoor": int(z)}
                      for x, y, z in fid).write(f("fid.xmd"))
    q["data_s"] = time.perf_counter() - t0
    tilt_args = ["--minTilt", TM_TILTS[0], "--maxTilt", TM_TILTS[1],
                 "--tiltStep", TM_TILTS[2]]
    for k in (0, 1):
        run(f"simulate_{k}", "tomo_simulate_tilt_series", [
            "--coordinates", f(f"coords{k}.xmd"), "--vol", f(f"part{k}.vol"),
            "--tiltseries", f(f"ts{k}.mrcs"), "--tomogram",
            f(f"tomo{k}.mrc"), "--xdim", size, "--ydim", size,
            "--thickness", thickness, *tilt_args, "--sampling", TM_TS]
            + (["--fiducialCoordinates", f("fid.xmd"), "--fiducialDiameter",
                TM_FID_A, "--sigmaNoise", TM_NOISE] if k == 0 else []))
    # the two states' runs summed: one tomogram of both (the noise and the
    # beads come with the first)
    t0 = time.perf_counter()
    series = stack("ts0.mrcs") + stack("ts1.mrcs")
    truth = load("tomo0.mrc") + load("tomo1.mrc")
    check(series.shape == (len(tilts), size, size)
          and truth.shape == (thickness, size, size),
          f"phase 16 simulator: {series.shape}, {truth.shape}")
    save_image(f("ts.mrcs"), series)
    save_image(f("tomo.mrc"), truth)
    ts_rows = [dict(r, image=r["image"].replace("ts0.mrcs", "ts.mrcs"))
               for r in rows_of("ts0.xmd")]
    MetaData.fromRows(ts_rows).write(f("ts.xmd"))
    # the reconstruction tilts about x (ROADMAP.md section 3, item 25): it
    # reads the series with each image transposed
    save_image(f("ts_xtilt.mrcs"),
               np.ascontiguousarray(series.transpose(0, 2, 1)))
    MetaData.fromRows(dict(r, image=r["image"].replace("ts.mrcs",
                                                       "ts_xtilt.mrcs"))
                      for r in ts_rows).write(f("ts_xtilt.xmd"))
    # the planted beads in each tilt image (the simulator's paste), the
    # planted points in the tomogram's index frame
    ct, st = np.cos(np.deg2rad(tilts)), np.sin(np.deg2rad(tilts))
    beads2d = np.array([(k, int(x * ct[k] + z * st[k]) + size // 2,
                         y + size // 2) for k in range(len(tilts))
                        for x, y, z in fid], np.float64)
    to_index = lambda p: p + [size // 2, size // 2, thickness // 2]
    MetaData.fromRows({"xcoor": int(x), "ycoor": int(y), "zcoor": int(z)}
                      for x, y, z in fid + [size // 2, size // 2, 0]
                      ).write(f("fid3d.xmd"))
    MetaData.fromRows({"xcoor": int(x), "ycoor": int(y), "zcoor": int(z)}
                      for x, y, z in to_index(pos)).write(f("parts3d.xmd"))
    q["data_s"] += time.perf_counter() - t0

    run("dose_filter", "tomo_tiltseries_dose_filter", [
        "-i", f("ts.xmd"), "-o", f("dose.mrcs"), "--dosePerImage", TM_DOSE,
        "--sampling", TM_TS])
    k = np.sqrt(np.fft.fftfreq(size)[:, None] ** 2
                + np.fft.rfftfreq(size)[None, :] ** 2) / TM_TS
    Nc = 0.24499 * np.maximum(k, 1e-6) ** -1.6649 + 2.8141
    some = [0, len(tilts) // 2, len(tilts) - 1]
    want = np.stack([np.fft.irfft2(np.fft.rfft2(series[i].astype(np.float64))
                                   * np.exp(-TM_DOSE * (i + 1) / (2 * Nc)),
                                   s=(size, size)) for i in some])
    q["dose_vs_numpy"] = float(np.abs(stack("dose.mrcs")[some] - want).max()
                               / np.abs(want).max())

    run("landmarks", "tomo_detect_landmarks", [
        "-i", f("ts.xmd"), "-o", f("lm.xmd"), "--samplingRate", TM_TS,
        "--fiducialSize", TM_FID_A])
    lm = rows_of("lm.xmd")
    found = [(r["frameId"] - 1, r["xcoor"], r["ycoor"]) for r in lm]
    # a hit lies in the right frame: frames sit 10 * size apart
    sep = lambda p: np.asarray(p, np.float64).reshape(-1, 3) * [
        10.0 * size, 1.0, 1.0]
    rec_, prec_ = hits(sep(found), sep(beads2d), TM_WITHIN)
    q["landmarks"] = {"found": len(lm), "recall": rec_, "precision": prec_}

    run("residuals", "tomo_calculate_landmark_residuals", [
        "-i", f("ts.xmd"), "--tlt", f("ts.xmd"), "--inputCoord",
        f("fid3d.xmd"), "-o", f("res.xmd"), "--samplingRate", TM_TS,
        "--fiducialSize", TM_FID_A])
    res = rows_of("res.xmd")
    r = np.array([np.hypot(x["shiftX"], x["shiftY"]) for x in res])
    q["residuals"] = {"rows": len(res), "rms_px": float(np.sqrt(
        (r ** 2).mean())), "zero": float((r == 0).mean())}
    run("misalignment", "tomo_detect_misalignment_residuals", [
        "--inputResInfo", f("res.xmd"), "-o", f("verdict.xmd")])
    q["misalignment_enabled"] = float(np.mean(
        [x["enabled"] == 1 for x in rows_of("verdict.xmd")]))
    run("resid_statistics", "tomo_misalignment_resid_statistics", [
        "-i", f("res.xmd"), "-o", f("stats.xmd")])
    frames = np.array([x["frameId"] for x in res])
    stats = rows_of("stats.xmd")
    q["statistics_vs_numpy"] = max(
        abs(s["avg"] - r[frames == s["frameId"]].mean())
        + abs(s["max"] - r[frames == s["frameId"]].max()) for s in stats)
    q["statistics_frames"] = len(stats)

    run("reconstruct", "tomogram_reconstruction", [
        "-i", f("ts_xtilt.xmd"), "-o", f("rec.mrc"), "--thickness",
        thickness])
    rec = load("rec.mrc")
    check(rec.shape == (thickness, size, size) and np.isfinite(rec).all(),
          f"phase 16 tomogram: {rec.shape}")
    # back to the simulator's frame: x and y swapped, z reversed
    save_image(f("rec_truth.mrc"),
               np.ascontiguousarray(rec[::-1].transpose(0, 2, 1)))
    rec_t = load("rec_truth.mrc")
    q["tomogram_corr"] = real_corr(lowpass_nd(rec_t, TM_LOWPASS),
                                   lowpass_nd(truth, TM_LOWPASS))
    extra["tomogram"] = (np.full(len(tilts), 90.0), tilts,
                         np.full(len(tilts), -90.0))

    q.update(wedge_and_beads(run, f("rec_truth.mrc"), to_index(fid),
                             fid_px))
    q["beads_truth"] = bead_readings(run, "beads_truth", f("tomo.mrc"),
                                     to_index(fid), fid_px)

    # the program keeps a coordinate whose z lies --radius inside the
    # tomogram: the radius scales with the thickness
    radius = TM_FILTER_RADIUS * thickness // TM_Z
    run("filter_coordinates", "tomo_filter_coordinates", [
        "--coordinates", f("parts3d.xmd"), "-o", f("filt.xmd"), "--inTomo",
        f("rec_truth.mrc"), "--radius", radius])
    rr = int(np.floor(np.sqrt(radius))) + 1
    off = np.mgrid[-rr:rr + 1, -rr:rr + 1, -rr:rr + 1]
    ball = (off ** 2).sum(0) <= radius
    errs = []
    for row in rows_of("filt.xmd"):
        x, y, z = (int(row[k]) for k in ("xcoor", "ycoor", "zcoor"))
        v = rec_t.astype(np.float64)[z + off[0][ball], y + off[1][ball],
                                     x + off[2][ball]]
        errs.append(max(abs(row["avg"] - v.mean()) / abs(v).max(),
                        abs(row["stddev"] - v.std()) / v.std()))
    q["filter"] = {"kept": len(errs), "vs_numpy": max(errs, default=1.0)}

    # dark particles: the subtomograms are cut with their contrast
    # inverted, to be held against the particles' positive densities
    run("extract", "tomo_extract_subtomograms", [
        "--tomogram", f("rec_truth.mrc"), "--coordinates", f("parts3d.xmd"),
        "--boxsize", box, "-o", f("sub"), "--invertContrast"])
    subs = rows_of("sub.xmd")
    q["extracted"] = len(subs)
    # the simulator rotates a particle by euler(psi, tilt, rot) of its
    # row: the average undoes it with those angles swapped
    key = {tuple(int(r[k]) for k in ("xcoor", "ycoor", "zcoor")): r
           for r in subs}
    posed = [[], []]
    for p, a, s in zip(to_index(pos), ang, state):
        r = key.get(tuple(int(v) for v in p))
        if r is not None:
            posed[s].append(dict(r, angleRot=float(a[2]),
                                 angleTilt=float(a[1]),
                                 anglePsi=float(a[0])))
    MetaData.fromRows(posed[0]).write(f("posed0.xmd"))
    run("average", "tomo_average_subtomos", [
        "-i", f("posed0.xmd"), "-o", f("avg.mrc")])
    q["average_corr"] = real_corr(load("avg.mrc"), parts[0])
    before = load("rec_truth.mrc")
    run("map_back", "tomo_map_back", [
        "-i", f("rec_truth.mrc"), "-o", f("mapback.mrc"), "--geom",
        f("posed0.xmd"), "--ref", f("part0.vol"), "--method",
        "highlight", 1])
    painted = load("mapback.mrc") - before
    q["map_back_mass"] = float(painted.sum() / (len(posed[0])
                                                * parts[0].sum()))
    # the subtraction on the first subtomograms of the same state cut from
    # the simulated tomogram, whose particles are the posed reference
    run("extract_truth", "tomo_extract_subtomograms", [
        "--tomogram", f("tomo.mrc"), "--coordinates", f("parts3d.xmd"),
        "--boxsize", box, "-o", f("subt"), "--invertContrast"])
    truth_subs = {tuple(int(r[k]) for k in ("xcoor", "ycoor", "zcoor")):
                  r["subtomoName"] for r in rows_of("subt.xmd")}
    MetaData.fromRows(
        dict(r, subtomoName=truth_subs[tuple(int(r[k]) for k in (
            "xcoor", "ycoor", "zcoor"))])
        for r in posed[0][:TM_SUBTRACT]).write(f("sub4.xmd"))
    run("subtract", "subtomo_subtraction", [
        "-i", f("sub4.xmd"), "--ref", f("part0.vol"), "--oroot",
        f("ss"), "--sub", "--saveV1", f("ss_v1.mrc"), "--saveV2",
        f("ss_v2.mrc")])
    e_in = sum(float((np.squeeze(Image(r["subtomoName"]).data) ** 2).sum())
               for r in rows_of("sub4.xmd"))
    e_out = sum(float((np.squeeze(Image(r["subtomoName"]).data) ** 2).sum())
                for r in rows_of("ss.xmd"))
    q["subtraction_energy"] = e_out / e_in

    defocus = np.interp(np.abs(tilts), [0, abs(TM_TILTS[0])], TM_CTF_DEFOCUS)
    planted = np.fft.irfft2(np.fft.rfft2(series) * np.stack(
        [plant_ctf(size, TM_TS, d, d + 500.0, 30.0) for d in defocus]),
        s=(size, size)).astype(np.float32)
    save_image(f("ts_ctf.mrcs"), planted)
    MetaData.fromRows(dict(
        r, image=r["image"].replace("ts.mrcs", "ts_ctf.mrcs"),
        ctfDefocusU=float(d), ctfDefocusV=float(d) + 500.0,
        ctfDefocusAngle=30.0, ctfVoltage=CTF_KV, ctfSphericalAberration=CTF_CS,
        ctfQ0=CTF_Q0, ctfSamplingRate=TM_TS) for r, d in zip(ts_rows, defocus)
    ).write(f("ts_ctf.xmd"))
    run("wiener", "tomo_ctf_wiener2d_correction", [
        "-i", f("ts_ctf.xmd"), "-o", f("wiener.mrcs"), "--sampling", TM_TS])
    corr = lambda a: float(np.mean([real_corr(x, y)
                                    for x, y in zip(a, series)]))
    q["wiener"] = {"raw": corr(planted), "corrected":
                   corr(stack("wiener.mrcs"))}

    run("project", "tomo_project", [
        "-i", f("part0.vol"), "-o", f("proj"), "--tiltRange", *TM_TILTS])
    want = FourierProjector(parts[0], device=device).project_euler(
        np.full(len(tilts), 90.0, np.float32), tilts.astype(np.float32),
        np.full(len(tilts), -90.0, np.float32)).cpu().numpy()
    q["project_vs_projector"] = float(np.abs(stack("proj.mrcs") - want).max()
                                      / np.abs(want).max())
    run("particlestacks", "tomo_extract_particlestacks", [
        "--tiltseries", f("ts.xmd"), "--coordinates", f("parts3d.xmd"),
        "--boxsize", box, "-o", f("pst")])
    pst = rows_of("pst/particlestacks.xmd")
    bad, stacks = 0, {}
    for r in pst:
        idx, fn = r["image"].split("@")
        if fn not in stacks:
            stacks[fn] = np.asarray(Image.read_stack(fn))
        t_ = np.deg2rad(r["tiltAngle"])
        x = int(round((r["xcoor"] - size / 2) * np.cos(t_)
                      + r["zcoor"] * np.sin(t_) + size / 2))
        y = int(r["ycoor"])
        bad += not np.array_equal(
            stacks[fn][int(idx) - 1],
            series[r["frameId"] - 1, y - box // 2:y + box // 2,
                   x - box // 2:x + box // 2])
    q["particlestacks"] = {"patches": len(pst), "differ": bad}

    # (b) classification
    t0 = time.perf_counter()
    sa, sb = (phantom(sub_n, b) for b in analysis_states(sub_n))
    rng = np.random.default_rng(seed + 47)
    fr = np.fft.fftfreq(sub_n)
    fz, _, fx = np.meshgrid(fr, fr, fr, indexing="ij")
    wedge = torch.as_tensor(np.abs(fz) <= np.abs(fx) * np.tan(
        np.deg2rad(TM_TILTS[1])) + 1e-9, device=device)
    sigma = TM_SUB_NOISE * float(np.std(sa))
    sub_state = rng.integers(0, 2, subtomos)
    shifts = rng.integers(-TM_SUB_SHIFT, TM_SUB_SHIFT + 1, (subtomos, 3))
    src = torch.as_tensor(np.stack([sa, sb]), device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 47)
    for lo in range(0, subtomos, 100):
        noise = sigma * torch.randn((min(100, subtomos - lo),)
                                    + (sub_n,) * 3, generator=gen,
                                    device=device)
        for j in range(len(noise)):
            i = lo + j
            v = torch.roll(src[sub_state[i]], tuple(int(s) for s in shifts[i]),
                           (0, 1, 2))
            v = torch.fft.ifftn(torch.fft.fftn(v) * wedge).real + noise[j]
            save_image(f(f"st{i:04d}.vol"), v.cpu().numpy())
    MetaData.fromRows({"image": f(f"st{i:04d}.vol"), "itemId": i + 1}
                      for i in range(subtomos)).write(f("subtomos.xmd"))
    q["sub_data_s"] = time.perf_counter() - t0
    prog = run("cltomo", "classify_CLTomo_prog", [
        "-i", f("subtomos.xmd"), "-o", f("cltomo.xmd"), "--oroot",
        f("cltomo_"), "--nref", 2])
    q["cltomo_purity"] = class_purity(prog.labels, sub_state)[0]

    t0 = time.perf_counter()
    _, clean, noise, crec = classify_views(n, fttri_views, seed, device)
    write_views(root, "fttri", clean + noise)
    q["fttri_data_s"] = time.perf_counter() - t0
    ft_args = ["-i", f("fttri.xmd"), "--oroot", f("ft"), "--nref", CLS_DIRS]
    prog = run("fttri", "classify_FTTRI", ft_args)
    q["fttri_purity"], q["fttri_won"] = class_purity(prog.labels,
                                                    crec["label"])
    if mesh is not None:
        mesh("fttri_mesh", "classify_FTTRI",
             ["-i", f("fttri.xmd"), "--oroot", f("ftm"), "--nref", CLS_DIRS])
        q["fttri_mesh_equal"] = [r["ref"] for r in rows_of("ftm_classes.xmd")
                                 ] == [r["ref"] for r in
                                       rows_of("ft_classes.xmd")]

    # (c) an initial volume from phase 4's views
    t0 = time.perf_counter()
    p4, rng4 = cycle_poses(seed)
    take = slice(0, anneal_views)
    clean = projections(n, *(p4[k][take] for k in
                             ("rot", "tilt", "psi", "sx", "sy")),
                        scaled_blobs(BLOBS8, n), device=device)
    views = clean + (0.5 * clean.std()) * rng4.standard_normal(
        clean.shape, dtype=np.float32)
    write_views(root, "anneal", views)
    ref = phantom(n, scaled_blobs(BLOBS8, n))
    save_image(f("phantom.vol"), ref)
    q["anneal_data_s"] = time.perf_counter() - t0
    run("anneal", "volume_initial_simulated_annealing", [
        "-i", f("anneal.xmd"), "--oroot", f("sa")])
    run("anneal_align", "volume_align", [
        "--i1", f("phantom.vol"), "--i2", f("sa.vol"), "--frm",
        "--consider_mirror", "--apply", f("sa_aligned.vol")])
    q["anneal_corr"] = real_corr(load("sa_aligned.vol"), ref)
    dirs = compute_sampling_points(20.0)
    extra["anneal"] = (ref, views, dirs)

    # (d) the tilt pairs, the model programs and the tests
    u, t, truth_idx = tilt_pair_coordinates(seed, TM_PAIRS, TM_PAIR_TILT)
    (root / "pairs").mkdir()
    for name, P_ in (("u.xmd", u), ("t.xmd", t)):
        MetaData.fromRows({"xcoor": int(x), "ycoor": int(y)} for x, y in P_
                          ).write(f(name))
    run("assign_pairs", "image_assignment_tilt_pair", [
        "--untiltcoor", f("u.xmd"), "--tiltcoor", f("t.xmd"), "--odir",
        f("pairs"), "--tiltangle", TM_PAIR_TILT])
    ua = [(r["xcoor"], r["ycoor"]) for r in rows_of("pairs/untilted_assigned.xmd")]
    ta = [(r["xcoor"], r["ycoor"]) for r in rows_of("pairs/tilted_assigned.xmd")]
    ui = {(int(x), int(y)): i for i, (x, y) in enumerate(u)}
    ti = {(int(x), int(y)): j for j, (x, y) in enumerate(t)}
    right = sum(truth_idx[ui[a]] == ti[b] for a, b in zip(ua, ta))
    q["pairs"] = {"assigned": len(ua), "recall": right / TM_PAIRS,
                  "precision": right / max(len(ua), 1)}

    pr = FourierProjector(ref, device=device).project_euler(
        [0.0], [0.0], [0.0]).cpu().numpy()[0]
    save_image(f("untilted.xmp"), pr)
    prng = np.random.default_rng(seed + 45)
    plant = prng.uniform(-TM_PAIR_SHIFT, TM_PAIR_SHIFT, (TM_PAIRS, 2))
    cosT = np.cos(np.deg2rad(TM_PAIR_TILT))
    A = np.tile(np.eye(3, dtype=np.float32), (TM_PAIRS, 1, 1))
    A[:, 0, 0] = cosT
    A[:, :2, 2] = plant
    tilted = apply_affine_2d(np.broadcast_to(pr, (TM_PAIRS, n, n)), A,
                             device=device).cpu().numpy()
    tilted += 0.1 * pr.std() * prng.standard_normal(tilted.shape,
                                                     dtype=np.float32)
    save_image(f("tilted.mrcs"), tilted)
    MetaData.fromRows({"image": f("untilted.xmp"),
                       "imageTilted": f"{i + 1:06d}@{f('tilted.mrcs')}",
                       "angleTilt": TM_PAIR_TILT} for i in range(TM_PAIRS)
                      ).write(f("tiltpairs.xmd"))
    run("align_pairs", "image_align_tilt_pairs", [
        "-i", f("tiltpairs.xmd"), "-o", f("tiltpairs_al.xmd"), "--ref",
        f("untilted.xmp")])
    al = rows_of("tiltpairs_al.xmd")
    got = np.array([[r["shiftX"], r["shiftY"]] for r in al])
    q["align_pairs"] = {"enabled": float(np.mean([r["enabled"] for r in al])),
                        "shift_err_px": float(np.median(np.hypot(
                            *(got + plant).T)))}

    model = synthetic_model(ANG_PDB_ATOMS, seed)
    write_pdb(f("model.pdb"), model)
    run("transform", "phantom_transform", [
        "-i", f("model.pdb"), "-o", f("moved.pdb"), "--operation",
        "rotate_euler", *TM_TRANSFORM])
    M = zyz64(*TM_TRANSFORM)
    moved = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                      for ln in open(f("moved.pdb"))
                      if ln.startswith(("ATOM", "HETATM"))])
    orig = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                     for ln in open(f("model.pdb"))
                     if ln.startswith(("ATOM", "HETATM"))])
    q["transform_err_A"] = float(np.abs(moved - orig @ M.T).max())

    run("web", "volume_to_web", [
        "-i", f("phantom.vol"), "--central_slices", f("slices.xmp"), 8,
        "--projections", f("projs.xmp"), "--maxWidth", 3 * (n + 2)])
    web = load("projs.xmp")
    want = np.concatenate([ref.sum(axis=a) for a in (0, 1, 2)], axis=1)
    q["web_vs_numpy"] = float(np.abs(np.delete(web, [n, n + 1, 2 * n + 2,
                                                     2 * n + 3], axis=1)
                                     - want).max() / np.abs(want).max())

    bf = np.random.default_rng(seed + 49).uniform(10, 90, ANG_PDB_ATOMS)
    with open(f("ca.pdb"), "w") as fh:
        for i, (x, y, z) in enumerate(model.coords):
            fh.write(f"ATOM  {i + 1:5d}  CA  ALA A{i + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00{bf[i]:6.2f}"
                     f"           C\n")
    g = np.arange(VL_N) - VL_N // 2
    locres = (2.0 + np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2
                            + g[None, None, :] ** 2) / 8.0).astype(np.float32)
    save_image(f("locres.vol"), locres)
    run("bfactor", "resolution_pdb_bfactor", [
        "--atmodel", f("ca.pdb"), "--vol", f("locres.vol"), "-o",
        f("bfactor.xmd"), "--centered", "--sampling", 1])
    want = {}
    for i, (x, y, z) in enumerate(model.coords):
        p = np.array([float(f"{x:8.3f}"), float(f"{y:8.3f}"),
                      float(f"{z:8.3f}")]) + VL_N // 2
        iz, iy, ix = (int(round(p[k])) for k in (2, 1, 0))
        if all(1 <= v < VL_N - 1 for v in (iz, iy, ix)):
            want[i + 1] = float(np.mean(locres[iz - 1:iz + 2, iy - 1:iy + 2,
                                               ix - 1:ix + 2]))
    got = {r["residue"]: r["resolution"] for r in rows_of("bfactor.xmd")}
    q["bfactor"] = {"residues": len(got), "same_residues": set(got) ==
                    set(want), "vs_numpy": max((abs(got[k] - want[k]) for k
                                                in want if k in got),
                                               default=1.0)}

    prog = run("performance", "performance_test", ["--size", 4 * n,
                                                   "--batch", 32])
    q["performance"] = prog.results
    prog = run("write", "write_test", ["--size", 256, "-o", f("wt.mrcs")])
    q["write_MB_s"] = prog.mb_per_s
    return q, extra


def tomography(seed, root: Path):
    """Phase 16 in root: the 28 programs of the tomography slice, the tail
    of flex_misc_ext and the three tilt programs through their CLI on the
    card (classify_FTTRI also with --mesh dp over 2 gloo ranks); only
    tomogram_reconstruction (K3) and volume_initial_simulated_annealing
    (K3 in its SIRT passes, K4 in its greedy matching) may launch a kernel.
    K3 is held against its plain version at the tomogram's one launch, K4
    at one trial of the annealing's greedy scan. Returns the two kernels'
    entries."""
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.ops.project import FourierProjector
    root.mkdir(parents=True)
    report = {}
    limit = Limits(16)
    kernel_of = {"reconstruct": {"kb_scatter_3ch"},
                 "anneal": {"kb_scatter_3ch", "cross_spectrum"}}

    def run(label, name, args):
        prog = run_program(16, report, label, name, args)
        got = set(report[label]["launches"])
        check(got == kernel_of.get(label, set()),
              f"phase 16 {label}: launched {got}, expected "
              f"{kernel_of.get(label) or 'no kernel'}")
        return prog

    def mesh(label, name, args):
        for r, rep in enumerate(run_mesh(report, root, label, name, args)):
            got = {k: v for k, v in rep["launches"].items() if v}
            check(not got, f"phase 16 {label} rank {r}: launched {got}")

    start = time.perf_counter()
    timing.enable_timing(True)
    try:
        q, extra = tomo_readings(seed, root, run, DEVICE, mesh=mesh)
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    report["quality"] = q
    report["phase_s"] = time.perf_counter() - start
    # the tomogram's one launch: every tilt image at N = TM_SIZE
    k3 = grid_at_views("kb_scatter_3ch_tomogram", "kb", *extra["tomogram"],
                       seed, chunk=RM_KB_CHUNK, reps=10, phase=16,
                       n=TM_SIZE, p=2 * TM_SIZE)
    k3["launches"] = report["reconstruct"]["launches"]["kb_scatter_3ch"]
    ref, views, dirs = extra["anneal"]
    gallery = FourierProjector(ref, device=DEVICE).project_euler(
        dirs[:, 0].astype(np.float32), dirs[:, 1].astype(np.float32),
        np.zeros(len(dirs), np.float32))
    k4 = cross_at_trial_shape("cross_spectrum_initial_volume", gallery,
                              views)
    k4["launches"] = report["anneal"]["launches"]["cross_spectrum"]
    report["kernels"] = {k["name"]: {x: k[x] for x in (
        "ms", "plain_ms", "bound_ms", "library_ms", "launches")}
        for k in (k3, k4)}
    log(f"  phase 16 took {report['phase_s']:.2f} s")
    log("tomo " + json.dumps(report))
    L = TM_LIMITS
    n_tilts = len(extra["tomogram"][1])
    limit(q["dose_vs_numpy"] <= TM_TOL, f"phase 16 dose filter: "
          f"{q['dose_vs_numpy']:.2e} off numpy")
    for k in ("landmarks", "beads_truth", "pairs"):
        limit(q[k]["recall"] >= L[k]["recall"]
              and q[k]["precision"] >= L[k]["precision"],
              f"phase 16 {k}: {q[k]} (limits {L[k]})")
    limit(q["residuals"]["rms_px"] <= L["residuals_rms_px"],
          f"phase 16 residuals: {q['residuals']}")
    limit(q["misalignment_enabled"] >= L["misalignment_enabled"],
          f"phase 16 misalignment: {q['misalignment_enabled']}")
    limit(q["statistics_vs_numpy"] <= TM_MD_TOL
          and q["statistics_frames"] == n_tilts,
          f"phase 16 statistics: {q['statistics_vs_numpy']:.2e}, "
          f"{q['statistics_frames']} frames")
    limit(q["tomogram_corr"] >= L["tomogram_corr"], f"phase 16 tomogram: "
          f"corr {q['tomogram_corr']:.4f} (limit {L['tomogram_corr']})")
    off = [plane_angle(p, r) for p, r in zip(q["wedge_planes"],
                                             TM_REF_WEDGE_PLANES)]
    limit(max(off) <= TM_WEDGE_PLANE_TOL, f"phase 16 missing wedge: planes "
          f"{q['wedge_planes']} are {off} degrees off the reference's")
    same = hits(q["beads"]["xyz"], np.array(TM_REF_BEADS, np.float64), 1.0)
    limit(same == (1.0, 1.0), f"phase 16 beads: {q['beads']['xyz']} against "
          f"the reference's {TM_REF_BEADS} (recall, precision {same})")
    limit(q["filter"]["kept"] == TM_PARTICLES
          and q["filter"]["vs_numpy"] <= TM_MD_TOL, f"phase 16 filter: "
          f"{q['filter']}")
    limit(q["extracted"] == TM_PARTICLES, f"phase 16 extracted "
          f"{q['extracted']} of {TM_PARTICLES}")
    limit(q["average_corr"] >= L["average_corr"], f"phase 16 average: "
          f"corr {q['average_corr']:.4f} (limit {L['average_corr']})")
    limit(abs(q["map_back_mass"] - 1) <= L["map_back_mass"],
          f"phase 16 map_back: mass ratio {q['map_back_mass']:.4f}")
    limit(q["subtraction_energy"] <= L["subtraction_energy"],
          f"phase 16 subtraction: energy ratio "
          f"{q['subtraction_energy']:.4f}")
    limit(q["wiener"]["corrected"] > q["wiener"]["raw"],
          f"phase 16 wiener: {q['wiener']}")
    limit(q["project_vs_projector"] <= 1e-5, f"phase 16 tomo_project: "
          f"{q['project_vs_projector']:.2e} off FourierProjector")
    limit(q["particlestacks"]["patches"] > 0
          and q["particlestacks"]["differ"] == 0,
          f"phase 16 particle stacks: {q['particlestacks']}")
    limit(q["cltomo_purity"] >= L["cltomo_purity"], f"phase 16 CLTomo: "
          f"purity {q['cltomo_purity']:.4f}")
    limit(q["fttri_purity"] >= L["fttri_purity"]
          and q["fttri_won"] >= L["fttri_won"]
          and q["fttri_mesh_equal"], f"phase 16 FTTRI: purity "
          f"{q['fttri_purity']:.4f}, {q['fttri_won']} won, mesh equal "
          f"{q['fttri_mesh_equal']}")
    limit(q["anneal_corr"] >= L["anneal_corr"], f"phase 16 annealing: "
          f"corr {q['anneal_corr']:.4f} (limit {L['anneal_corr']})")
    limit(q["align_pairs"]["enabled"] >= L["align_pairs"]["enabled"]
          and q["align_pairs"]["shift_err_px"]
          <= L["align_pairs"]["shift_err_px"],
          f"phase 16 align_tilt_pairs: {q['align_pairs']}")
    limit(q["transform_err_A"] <= 1e-3, f"phase 16 phantom_transform: "
          f"{q['transform_err_A']:.2e} A")
    limit(q["web_vs_numpy"] <= TM_TOL, f"phase 16 volume_to_web: "
          f"{q['web_vs_numpy']:.2e}")
    limit(q["bfactor"]["same_residues"] and q["bfactor"]["vs_numpy"]
          <= TM_MD_TOL, f"phase 16 resolution_pdb_bfactor: {q['bfactor']}")
    limit(all(np.isfinite(v) and v > 0 for v in
              q["performance"].values()) and q["write_MB_s"] > 0,
          f"phase 16 tests: {q['performance']}, {q['write_MB_s']}")
    limit.check()
    return [k3, k4]


# ---------------------------------------------------------------------------
# phase 17: the long tail (deep programs, final_batch, scripts_misc,
# matlab_bridge, infra)
# ---------------------------------------------------------------------------

TL_N = 64                      # views, boxes and subtomogram-free 2-D inputs
# the deep recipes are cut to keep the script inside its 1,200 s on a slow
# host: at 1,000 boxes and candidates, 2,000 views, 500 patches and 20-30
# epochs it took 1,141.1 s there (PERF.md section 4)
TL_BOXES = 500                 # deep_consensus: particle and noise boxes each
TL_CANDIDATES = 500            # ... and of each kind among the scored
TL_NOISE = 1.0                 # boxes' noise, x the views' std
TL_GA_VIEWS = 1000             # deep_global_assignment's training views
TL_GA_TEST = 500               # ... and its held-out views
TL_GA_NOISE = 0.5
TL_MIC = 4096                  # the micrograph of the cleaner, preprocess and
TL_MIC_VIEWS = 300             # extraction: views planted in its clean part
TL_CARBON = 1024               # columns x < TL_CARBON are carbon
TL_PATCHES = 250               # the cleaner's good and bad training patches
TL_HAND_N, TL_HAND_VOLS = 64, 4
TL_HAND_BLOBS = 12
TL_RES = (3.0, 10.0, 8)        # deepRes: training resolutions (A at 1 A/px)
TL_RES_TRAIN_N = 64
TL_RES_ZONES = (4.0, 8.0)      # the applied map: inner and outer resolution
TL_SUB_N, TL_SUBTOMOS = 32, 200  # misalignment: per class, train and test
TL_SUB_NOISE = 0.5
TL_POST_N, TL_POST_PAIRS = 64, 4
TL_POST_BLUR = 0.15            # the inputs' low-pass (cycles/px) ...
TL_POST_NOISE = 0.3            # ... and noise, x the clean map's std
TL_BIG_N = 128                 # compare_density, Wiener 3-D, grey levels,
TL_DEGSTEP = 10.0              # deepRes's and the postprocessing's maps
TL_WIENER_DEFOCUS = (10000.0, 20000.0)
TL_WIENER_TS = 2.0
TL_GREY_AB = (1.5, 0.3)
TL_GREY_VIEWS = 500
TL_SET_N, TL_SET_VOLS = 64, 8
TL_SET_STEP = 30.0             # volumeset_align --step: the planted rotations
                               # lie on its sphere grid
TL_VIEWS = 2000                # swiftalign, align_pca_2d
TL_DIRS = 16                   # directions of the classification views
TL_AVG_COPIES = 4              # cl2d_clustering: noisy copies of each
TL_GRAPH = 400                 # graph_max_cut's nodes (two communities)
TL_EPOCHS = {"consensus": 10, "ga": 15, "cleaner": 10, "hand": 10,
             "deepres": 20, "misalign": 20, "post": 20}
TL_TOL = 1e-4                  # numpy checks and card against CPU
TL_DEVICE_BRIDGE = ("rotate", "scale", "scale_pyramid", "normalize",
                    "ctf_correct_phase", "psd_enhance", "periodogram",
                    "ctf_generate_filter", "resolution", "align2d")

# twice the shortfall of the reference's readings on the CPU
# (tools/plan_tail.py, the same recipes), or half the reading where that is
# higher; twice an error. A trained classifier's held-out accuracy counts
# its shortfall as at least one held-out sample (a perfect reading on n
# cannot tell a shortfall below 1/n); the misalignment detector's is the
# worst of its recipe's draw and four more (`tools/plan_tail.py --part
# misalign`: 0.9975; 0.9975, 0.995, 1.0, 0.995). volumeset_align's planted
# rotations lie on its grid, where the reference read float32 noise
# (0.006 degrees): its limit is half a grid step.
TL_LIMITS = {
    "consensus_acc": 1 - 2 / (2 * TL_CANDIDATES),   # read 1.0
    "ga_median_err_deg": 69.546,          # read 34.773
    "cleaner_acc": 0.99915,               # read 0.99957
    "hand_p": 0.2520,                     # read 0.5040 (no hand learned)
    "hand_p_mirror": 0.7521,              # read 0.5041
    "deepres_err_A": 3.7248,              # read 1.8624 (zones 5.862, 7.319)
    "misalign_acc": 0.99,                 # read 0.9975, 0.995 at worst
    "post_corr": 0.78487,                 # read 0.89243 (input 0.81514)
    "compare_positive": 1.0,              # read 1.0
    "wiener_corr": 0.98123,               # read 0.99061
    "grey_err": 1.6212e-5,                # read 8.106e-6
    "consensus_corr": 0.98229,            # read 0.99114
    "volumeset_err_deg": TL_SET_STEP / 2,
    "zones_band_removed": 1.0,            # read 1.0
    "zones_clear_kept": 0.96139,          # read 0.98069
    "swift_purity": 0.672,                # read 0.836
    "cl2d_purity": 0.9375,                # read 0.96875
    "pca_avg_corr": 0.99849,              # read 0.99925
    "maxcut_agree": 1.0,                  # read 1.0
    "bridge_defocus_err": 2.6786e-3,      # read 1.339e-3
}


def mic_views(size: int, n: int) -> int:
    """The views planted in a size^2 micrograph of picking_micrographs:
    TL_MIC_VIEWS, or half its cells where that is fewer."""
    return min(TL_MIC_VIEWS, (size // (PK_CELL * n // N)) ** 2 // 2)


def blob_volumes(n: int, centres, sigma: float, device):
    """(V, n, n, n) float32 numpy: volume v the sum of unit Gaussians of
    width sigma at centres[v] ((V, K, 3) as (z, y, x) from the centre),
    on `device` in float32."""
    import torch
    c = torch.arange(n, dtype=torch.float32, device=device) - n // 2
    out = np.zeros((len(centres), n, n, n), np.float32)
    for v, cs in enumerate(np.asarray(centres, np.float32)):
        acc = torch.zeros((n, n, n), dtype=torch.float32, device=device)
        for cz, cy, cx in cs:
            acc += torch.exp(-((c[:, None, None] - float(cz)) ** 2
                               + (c[None, :, None] - float(cy)) ** 2
                               + (c[None, None, :] - float(cx)) ** 2)
                             / (2 * sigma * sigma))
        out[v] = acc.cpu().numpy()
    return out


def lowpass_stack(x, cutoff: float):
    """Each image or volume of x (numpy) low-passed at `cutoff` cycles/px
    (a hard sphere, numpy float64)."""
    axes = tuple(range(1, x.ndim))
    f = np.meshgrid(*[np.fft.fftfreq(s) for s in x.shape[1:-1]],
                    np.fft.rfftfreq(x.shape[-1]), indexing="ij")
    keep = sum(g * g for g in f) <= cutoff * cutoff
    return np.fft.irfftn(np.fft.rfftn(x, axes=axes) * keep,
                         s=x.shape[1:], axes=axes).astype(np.float32)


def rotation_matrices(rng, k: int):
    """k uniform random rotations (numpy float64, (k, 3, 3))."""
    q = rng.standard_normal((k, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def accuracy(pred, truth) -> float:
    return float(np.mean(np.asarray(pred) == np.asarray(truth)))


def view_set(rng, n: int, views: int, noise: float, device, psi=True,
             shift=3.0):
    """Noisy views of BLOBS8 at n: uniform directions, random psi (or 0)
    and shifts in +-shift px; numpy's draws, the views on `device`.
    Returns (noisy, clean, (rot, tilt, psi, sx, sy))."""
    rot = rng.uniform(0, 360, views)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, views)))
    ps = rng.uniform(0, 360, views) if psi else np.zeros(views)
    sx, sy = rng.uniform(-shift, shift, (2, views))
    clean = projections(n, rot, tilt, ps, sx, sy, scaled_blobs(BLOBS8, n),
                        device=device)
    sigma = float(clean.std())
    noisy = clean + np.float32(noise * sigma) * rng.standard_normal(
        clean.shape, dtype=np.float32)
    return noisy, clean, (rot, tilt, ps, sx, sy)


def write_stack_md(root: Path, name: str, imgs, extra=None):
    """imgs as root/name.mrcs with a metadata root/name.xmd (its rows'
    extra labels from `extra`, a dict of per-row sequences)."""
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    stk = str(root / f"{name}.mrcs")
    save_image(stk, np.asarray(imgs, np.float32))
    extra = extra or {}
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "itemId": i + 1,
         **{k: (v[i].item() if hasattr(v[i], "item") else v[i])
            for k, v in extra.items()}}
        for i in range(len(imgs))).write(str(root / f"{name}.xmd"))
    return str(root / f"{name}.xmd")


def write_volume_md(root: Path, name: str, vols, extra=None):
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    rows = []
    for i, v in enumerate(vols):
        fn = str(root / f"{name}_{i:03d}.mrc")
        save_image(fn, np.asarray(v, np.float32))
        rows.append({"image": fn, **{k: float(x[i]) for k, x in
                                     (extra or {}).items()}})
    MetaData.fromRows(rows).write(str(root / f"{name}.xmd"))
    return str(root / f"{name}.xmd")


def misalign_readings(rng, root: Path, run, device,
                      subtomos: int = TL_SUBTOMOS,
                      epochs: int = TL_EPOCHS["misalign"]):
    """deep_misalignment_detection trained on 2 x subtomos subtomograms at
    TL_SUB_N^3 (the 8-blob phantom at its pose within 1 px, or turned by a
    random rotation; noise of TL_SUB_NOISE x the std; numpy's draws from
    rng) and scored on 2 x subtomos more. Returns (held-out accuracy,
    seconds making the data, the held-out volumes)."""
    t0 = time.perf_counter()
    sn = TL_SUB_N
    base = np.array([(cz, cy, cx) for cz, cy, cx, _, _ in
                     scaled_blobs(BLOBS8, sn)], np.float64)
    k2 = 4 * subtomos
    R = rotation_matrices(rng, k2)
    # aligned: jitter of <= 1 px; misaligned: a random rotation
    cen = np.empty((k2, len(base), 3))
    lab = np.arange(k2) % 2
    for i in range(k2):
        cen[i] = base @ R[i].T if lab[i] == 0 else \
            base + rng.uniform(-1, 1, 3)
    sv = blob_volumes(sn, cen, 2.0, device)
    sv += np.float32(TL_SUB_NOISE * sv.std()) * rng.standard_normal(
        sv.shape, dtype=np.float32)
    tr = slice(0, 2 * subtomos)
    te = slice(2 * subtomos, k2)
    f = lambda name: str(root / name)
    good_md = write_volume_md(root, "sub_good", sv[tr][lab[tr] == 1])
    bad_md = write_volume_md(root, "sub_bad", sv[tr][lab[tr] == 0])
    test_md = write_volume_md(root, "sub_test", sv[te])
    data_s = time.perf_counter() - t0
    run("deep_misalignment_detection", "deep_misalignment_detection", [
        "-i", test_md, "-o", f("sub_scored.xmd"), "--goodTrain", good_md,
        "--badTrain", bad_md, "--train", "--epochs", epochs,
        "--model", f("misalign.pkl")])
    got = [r["enabled"] for r in md_rows(f("sub_scored.xmd"))]
    return (accuracy(got, np.where(lab[te] == 1, 1, -1)), data_s,
            sv[te])


def tail_deep_readings(seed, root: Path, run, device, n: int = TL_N,
                       boxes: int = TL_BOXES,
                       candidates: int = TL_CANDIDATES,
                       ga_views: int = TL_GA_VIEWS, mic: int = TL_MIC,
                       hand_n: int = TL_HAND_N, big_n: int = TL_BIG_N,
                       subtomos: int = TL_SUBTOMOS, epochs=None):
    """Phase 17's deep programs on their recipes (part (a)): each trains
    through its CLI with --train and scores held-out data; run(label,
    program, args) runs one program (the port's on the card in this
    script, the reference's on the CPU in tools/plan_tail.py). Returns
    (quality readings, {label: (model file, kind, n_out, inputs)} for the
    card-against-CPU check)."""
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    f = lambda name: str(root / name)
    load = lambda name: np.squeeze(Image(f(name)).data)
    ep = {**TL_EPOCHS, **(epochs or {})}
    rng = np.random.default_rng(seed + 171)
    q, models = {}, {}
    nrm = lambda x: (x - x.mean(axis=tuple(range(1, x.ndim)), keepdims=True)
                     ) / np.maximum(x.std(axis=tuple(range(1, x.ndim)),
                                          keepdims=True), 1e-8)

    # consensus: particle boxes against noise boxes, then held-out ones
    t0 = time.perf_counter()
    views, _, _ = view_set(rng, n, 2 * boxes + candidates, TL_NOISE, device)
    sigma = float(views.std())
    noise = lambda k: np.float32(sigma) * rng.standard_normal(
        (k, n, n), dtype=np.float32)
    pos = write_stack_md(root, "pos", views[:boxes])
    neg = write_stack_md(root, "neg", noise(boxes))
    cand_imgs = np.concatenate([views[2 * boxes:], noise(candidates)])
    cand = write_stack_md(root, "cand", cand_imgs)
    q["data_s"] = time.perf_counter() - t0
    run("deep_consensus", "deep_consensus", [
        "-i", cand, "-o", f("cand_scored.xmd"), "--posTrain", pos,
        "--negTrain", neg, "--train", "--epochs", ep["consensus"],
        "--model", f("consensus.pkl")])
    got = [r["enabled"] for r in md_rows(f("cand_scored.xmd"))]
    q["consensus_acc"] = accuracy(got, [1] * candidates + [-1] * candidates)
    models["deep_consensus"] = ("consensus.pkl", "ConvNet2D", 2,
                                nrm(cand_imgs[::8]))

    # global assignment: directions of views without psi or shifts
    t0 = time.perf_counter()
    gv, _, (rot, tilt, *_) = view_set(rng, n, ga_views + TL_GA_TEST,
                                      TL_GA_NOISE, device, psi=False,
                                      shift=0.0)
    ext = {"angleRot": rot, "angleTilt": tilt}
    train = write_stack_md(root, "ga_train", gv[:ga_views],
                           {k: v[:ga_views] for k, v in ext.items()})
    test = write_stack_md(root, "ga_test", gv[ga_views:])
    q["data_s"] += time.perf_counter() - t0
    run("deep_global_assignment", "deep_global_assignment", [
        "-i", train, "--epochs", ep["ga"], "--model", f("ga.pkl")])
    run("deep_global_assignment_predict", "deep_global_assignment_predict",
        ["-i", test, "-o", f("ga_pred.xmd"), "--model", f("ga.pkl")])
    pr = md_rows(f("ga_pred.xmd"))
    unit = lambda r, t: np.stack([np.sin(t) * np.cos(r),
                                  np.sin(t) * np.sin(r), np.cos(t)], -1)
    u_got = unit(np.radians([x["angleRot"] for x in pr]),
                 np.radians([x["angleTilt"] for x in pr]))
    u_want = unit(np.radians(rot[ga_views:]), np.radians(tilt[ga_views:]))
    q["ga_median_err_deg"] = float(np.median(np.degrees(np.arccos(
        np.clip((u_got * u_want).sum(-1), -1, 1)))))
    models["deep_global_assignment"] = ("ga.pkl", "ConvNet2D", 3,
                                        nrm(gv[ga_views::4]))

    # micrograph cleaner: carbon (a smooth strong texture) on the left
    t0 = time.perf_counter()
    mics, xy, _ = picking_micrographs(n, mic, mic_views(mic, n), seed,
                                      device)
    m = mics[0]
    carbon_w = TL_CARBON * mic // TL_MIC
    tex = lowpass_stack(rng.standard_normal((1, mic, carbon_w + 2 * n),
                                            dtype=np.float32), 0.02)[0]
    tex *= np.float32(3 * m.std() / tex.std())
    m[:, :carbon_w] += tex[:, :carbon_w]
    save_image(f("mic.mrc"), m)
    # training patches from the other micrograph: clean ice, and carbon
    m2 = mics[1]
    py, px = rng.integers(0, mic - n, (2, TL_PATCHES))
    good = np.stack([m2[y:y + n, x:x + n] for y, x in zip(py, px)])
    tx = rng.integers(0, tex.shape[1] - n, TL_PATCHES)
    bad = np.stack([m2[y:y + n, x:x + n] + tex[y:y + n, t:t + n]
                    for y, x, t in zip(py, px, tx)])
    gmd = write_stack_md(root, "good", good)
    bmd = write_stack_md(root, "bad", bad)
    q["data_s"] += time.perf_counter() - t0
    run("deep_micrograph_cleaner", "deep_micrograph_cleaner", [
        "-i", f("mic.mrc"), "-o", f("mic_mask.mrc"), "--boxSize", n,
        "--goodTrain", gmd, "--badTrain", bmd, "--train", "--epochs",
        ep["cleaner"], "--model", f("cleaner.pkl")])
    mask = load("mic_mask.mrc")
    truth = np.ones_like(mask, bool)
    truth[:, :carbon_w] = False
    q["cleaner_acc"] = float(((mask > 0.5) == truth).mean())
    models["deep_micrograph_cleaner"] = ("cleaner.pkl", "ConvNet2D", 2,
                                         nrm(np.concatenate([good[:64],
                                                             bad[:64]])))

    # handedness: random blob sets and their mirrors
    t0 = time.perf_counter()
    cen = rng.uniform(-hand_n / 4, hand_n / 4,
                      (TL_HAND_VOLS + 1, TL_HAND_BLOBS, 3))
    hv = blob_volumes(hand_n, cen, hand_n / 24, device)
    vols_md = write_volume_md(root, "hand", hv[:TL_HAND_VOLS])
    save_image(f("hand_test.mrc"), hv[-1])
    save_image(f("hand_mirror.mrc"), np.ascontiguousarray(hv[-1][:, :, ::-1]))
    q["data_s"] += time.perf_counter() - t0
    run("deep_hand", "deep_hand", [
        "-i", f("hand_test.mrc"), "-o", f("hand.txt"), "--trainVols",
        vols_md, "--train", "--epochs", ep["hand"], "--model",
        f("hand.pkl")])
    run("deep_hand_mirror", "deep_hand", [
        "-i", f("hand_mirror.mrc"), "-o", f("hand_mirror.txt"), "--model",
        f("hand.pkl")])
    q["hand_p"] = float(open(f("hand.txt")).read())
    q["hand_p_mirror"] = float(open(f("hand_mirror.txt")).read())
    models["deep_hand"] = ("hand.pkl", "ConvNet3D", 2, nrm(np.stack(
        [np.rot90(hv[-1], k, axes=(1, 2)) for k in range(4)])))

    # deepRes: densities low-passed to planted resolutions (1 A/px)
    t0 = time.perf_counter()
    lo, hi, k = TL_RES
    res = np.linspace(lo, hi, k)
    rn = TL_RES_TRAIN_N
    dens = blob_volumes(rn, rng.uniform(-rn / 3, rn / 3, (k, 60, 3)), 1.5,
                        device)
    train = np.concatenate([lowpass_stack(dens[i:i + 1], 1.0 / r)
                            for i, r in enumerate(res)])
    res_md = write_volume_md(root, "res", train, {"resolution": res})
    big = blob_volumes(big_n, rng.uniform(-big_n / 3, big_n / 3,
                                          (1, 240, 3)), 1.5, device)
    c = np.arange(big_n, dtype=np.float32) - big_n // 2
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    inner, outer = r < big_n * 0.2, r > big_n * 0.32
    zoned = np.where(r < big_n * 0.26,
                     lowpass_stack(big, 1 / TL_RES_ZONES[0])[0],
                     lowpass_stack(big, 1 / TL_RES_ZONES[1])[0])
    save_image(f("res_map.mrc"), zoned.astype(np.float32))
    q["data_s"] += time.perf_counter() - t0
    run("deepRes_resolution", "deepRes_resolution", [
        "-i", f("res_map.mrc"), "-o", f("res_out.mrc"), "--trainVols",
        res_md, "--patch", 16, "--train", "--epochs", ep["deepres"],
        "--model", f("deepres.pkl")])
    rm = load("res_out.mrc")
    q["deepres_zone_A"] = [float(np.median(rm[inner])),
                           float(np.median(rm[outer]))]
    q["deepres_err_A"] = float(max(abs(q["deepres_zone_A"][0]
                                       - TL_RES_ZONES[0]),
                                   abs(q["deepres_zone_A"][1]
                                       - TL_RES_ZONES[1])))
    # the alias, on the trained model
    run("deep_res_resolution", "deep_res_resolution", [
        "-i", f("res_map.mrc"), "-o", f("res_out_alias.mrc"), "--patch", 16,
        "--model", f("deepres.pkl")])
    q["deepres_alias_same"] = bool(np.abs(load("res_out_alias.mrc") - rm)
                                   .max() <= 1e-6 * np.abs(rm).max())
    models["deepRes_resolution"] = ("deepres.pkl", "ConvNet3D", 1, nrm(
        zoned[None, 40:56, 40:56, 40:56].repeat(2, 0)))

    # misalignment: the phantom at its pose against turned copies (a
    # Generator of its own: its draws do not move with the recipes above)
    q["misalign_acc"], data_s, test = misalign_readings(
        np.random.default_rng(seed + 173), root, run, device, subtomos,
        ep["misalign"])
    q["data_s"] += data_s
    models["deep_misalignment_detection"] = ("misalign.pkl", "ConvNet3D",
                                             2, nrm(test[:32]))

    # postprocessing: blurred, noisy densities against the clean ones
    t0 = time.perf_counter()
    pn = TL_POST_N

    def degrade(v):
        out = lowpass_stack(v, TL_POST_BLUR)
        return out + np.float32(TL_POST_NOISE * v.std()) * \
            rng.standard_normal(v.shape, dtype=np.float32)

    clean = blob_volumes(pn, rng.uniform(-pn / 3, pn / 3,
                                         (TL_POST_PAIRS, 60, 3)), 1.5, device)
    pairs = []
    for i, v in enumerate(clean):
        a, b = f(f"post_in_{i}.mrc"), f(f"post_ref_{i}.mrc")
        save_image(a, degrade(v[None])[0])
        save_image(b, v)
        pairs.append({"image": a, "imageRef": b})
    MetaData.fromRows(pairs).write(f("post_pairs.xmd"))
    bigin = degrade(big)[0]
    save_image(f("post_map.mrc"), bigin)
    q["data_s"] += time.perf_counter() - t0
    run("deep_volume_postprocessing", "deep_volume_postprocessing", [
        "-i", f("post_map.mrc"), "-o", f("post_out.mrc"), "--trainPairs",
        f("post_pairs.xmd"), "--train", "--epochs", ep["post"], "--model",
        f("post.pkl")])
    q["post_corr"] = real_corr(load("post_out.mrc"), big[0])
    q["post_input_corr"] = real_corr(bigin, big[0])
    models["deep_volume_postprocessing"] = ("post.pkl", "UNet3DLite", None,
                                            nrm(bigin[None, :64, :64, :64]))
    return q, models


def tail_misc_readings(seed, root: Path, run, device, n: int = TL_N,
                       big_n: int = TL_BIG_N, set_n: int = TL_SET_N,
                       views: int = TL_VIEWS, mic_size: int = TL_MIC):
    """Phase 17's final_batch, scripts_misc, matlab_bridge and infra
    programs on their recipes (part (b)); run as in tail_deep_readings.
    Returns (quality readings, the bridge's (function, input, output)
    triples for the card-against-CPU check)."""
    import shutil as _shutil
    from scipy.io import loadmat, savemat
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.pdb import read_pdb, write_pdb
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    from xmipp3_tpu_torch.ops.geo import apply_affine_3d
    from xmipp3_tpu_torch.ops.project import project_real_space
    from xmipp3_tpu_torch.programs.volume_programs import ProgVolumeAlign
    f = lambda name: str(root / name)
    load = lambda name: np.squeeze(Image(f(name)).data)
    rng = np.random.default_rng(seed + 172)
    q = {"data_s": 0.0}

    # (b1) maps at big_n: compare_density, Wiener 3-D, grey levels,
    # volume_consensus
    t0 = time.perf_counter()
    blobs = scaled_blobs(BLOBS8, big_n)
    v = phantom(big_n, blobs)
    save_image(f("v.vol"), v)
    # compare_density: a blob, and the blob with a satellite (the pair of
    # the reference's tests/test_final_batch.py, at big_n)
    k = big_n / 64
    main = phantom(big_n, [(0.0, 0.0, 0.0, np.sqrt(20.0) * k, 1.0)])
    sat = phantom(big_n, [(22 * k, 22 * k, 0.0, np.sqrt(7.0) * k, 1.0)])
    save_image(f("cd_main.vol"), main)
    save_image(f("cd_sat.vol"), main + sat)
    q["data_s"] += time.perf_counter() - t0
    run("compare_density", "compare_density", [
        "-v1", f("cd_sat.vol"), "-v2", f("cd_main.vol"), "-o", f("cd.xmp"),
        "--degstep", TL_DEGSTEP])
    cc = load("cd.xmp")
    nz = cc[cc != 0]
    q["compare_density"] = {"shape": list(cc.shape), "nonzero": float(
        (cc != 0).mean()), "positive": float((nz > 0).mean()) if len(nz)
        else 0.0}

    t0 = time.perf_counter()
    groups = []
    for g, dfu in enumerate(TL_WIENER_DEFOCUS):
        ctf = CTFDescription(sampling_rate=TL_WIENER_TS, voltage=300.0,
                             defocusU=dfu, defocusV=dfu, Cs=2.7, Q0=0.1)
        fz = np.fft.fftfreq(big_n)[:, None, None]
        fy = np.fft.fftfreq(big_n)[None, :, None]
        fx = np.fft.rfftfreq(big_n)[None, None, :]
        rr = (np.sqrt(fz ** 2 + fy ** 2 + fx ** 2) / TL_WIENER_TS).astype(
            np.float32)
        c = ctf.pure_at(rr, np.zeros_like(rr), device="cpu").numpy()
        gv = np.fft.irfftn(np.fft.rfftn(v) * c, s=v.shape)
        gv = gv + 0.1 * gv.std() * rng.standard_normal(gv.shape)
        save_image(f(f"group{g}.vol"), gv.astype(np.float32))
        ctf.to_metadata().write(f(f"group{g}.ctfparam"))
        groups.append({"image": f(f"group{g}.vol"),
                       "ctfModel": f(f"group{g}.ctfparam"),
                       "classCount": 100 * (g + 1)})
    MetaData.fromRows(groups).write(f("groups.xmd"))
    q["data_s"] += time.perf_counter() - t0
    run("ctf_correct_wiener3d", "ctf_correct_wiener3d", [
        "-i", f("groups.xmd"), "--oroot", f("wiener"), "--wienerConstant",
        0.01])
    q["wiener_corr"] = real_corr(load("wiener_deconvolved.vol"), v)
    q["wiener_group_corr"] = max(real_corr(load(f"group{g}.vol"), v)
                                 for g in range(2))

    t0 = time.perf_counter()
    a, b = TL_GREY_AB
    rot = rng.uniform(0, 360, TL_GREY_VIEWS).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, TL_GREY_VIEWS))).astype(
        np.float32)
    psi = rng.uniform(0, 360, TL_GREY_VIEWS).astype(np.float32)
    P = project_real_space(v, rot, tilt, psi, device=device).cpu().numpy()
    T = project_real_space(np.ones_like(v), rot, tilt, psi,
                           device=device).cpu().numpy()
    grey_md = write_stack_md(root, "grey", a * P + b * T, {
        "angleRot": rot, "angleTilt": tilt, "anglePsi": psi})
    q["data_s"] += time.perf_counter() - t0
    prog = run("adjust_volume_grey_levels",
               "transform_adjust_volume_grey_levels", [
                   "-i", f("v.vol"), "-m", grey_md, "-o", f("v_grey.vol"),
                   "--optimize", "--probb_eval", 0.5, "--seed", seed])
    ga, gb = prog.ab
    q["grey_err"] = float(max(abs(ga - a) / a, abs(gb - b) / b))

    t0 = time.perf_counter()
    cons = []
    for k in range(3):
        cons.append(f(f"cons{k}.vol"))
        save_image(cons[-1], (v + 0.3 * v.std() * rng.standard_normal(
            v.shape)).astype(np.float32))
    with open(f("cons.txt"), "w") as fh:
        fh.write("\n".join(cons))
    q["data_s"] += time.perf_counter() - t0
    run("volume_consensus", "volume_consensus", ["-i", f("cons.txt"),
                                                 "-o", f("cons.vol")])
    q["consensus_corr"] = real_corr(load("cons.vol"), v)
    q["consensus_input_corr"] = float(np.mean(
        [real_corr(np.squeeze(Image(c).data), v) for c in cons]))

    # (b2) volumeset_align on set_n maps turned by planted rotations, drawn
    # from its --step search's grid
    from xmipp3_tpu_torch.core.sampling import compute_sampling_points
    t0 = time.perf_counter()
    vs = phantom(set_n, scaled_blobs(BLOBS8, set_n))
    save_image(f("set_ref.vol"), vs)
    pts = compute_sampling_points(TL_SET_STEP)
    psis = np.arange(-180.0, 180.0, TL_SET_STEP)
    planted = []
    rows = []
    for i in range(TL_SET_VOLS):
        r_, t_ = pts[rng.integers(len(pts))]
        ang = (r_, t_, psis[rng.integers(len(psis))])
        A = ProgVolumeAlign._trial_matrix(1.0, *ang, 1.0, 0, 0, 0)
        moved = apply_affine_3d(vs, np.linalg.inv(A)[None, :3, :4].astype(
            np.float32), device=device)[0].cpu().numpy()
        save_image(f(f"set_{i}.vol"), moved)
        planted.append(A)
        rows.append({"image": f(f"set_{i}.vol"), "itemId": i + 1})
    MetaData.fromRows(rows).write(f("set.xmd"))
    q["data_s"] += time.perf_counter() - t0
    run("volumeset_align", "volumeset_align", [
        "-i", f("set.xmd"), "--ref", f("set_ref.vol"), "-o",
        f("set_al.xmd"), "--step", TL_SET_STEP])
    # the mpi_ alias resumes the finished run: every volume is skipped
    run("mpi_volumeset_align", "mpi_volumeset_align", [
        "-i", f("set.xmd"), "--ref", f("set_ref.vol"), "-o",
        f("set_al.xmd"), "--step", TL_SET_STEP, "--resume"])
    errs = []
    for r, A in zip(md_rows(f("set_al.xmd")), planted):
        B = ProgVolumeAlign._trial_matrix(1.0, r["angleRot"], r["angleTilt"],
                                          r["anglePsi"], 1.0, 0, 0, 0)
        errs.append(rotation_angle_deg(B, A))
    q["volumeset_err_deg"] = float(max(errs))

    # (b3) atomic models: analysis, labels, reduction, deformation, centre,
    # selection
    t0 = time.perf_counter()
    model = synthetic_model(ANG_PDB_ATOMS, seed)
    write_pdb(f("model.pdb"), model)
    q["data_s"] += time.perf_counter() - t0
    run("pdb_analysis", "pdb_analysis", [
        "-i", f("model.pdb"), "--operation", "distance_histogram",
        f("hist.txt"), 3, -1])
    from scipy.spatial import cKDTree
    c64 = read_pdb(f("model.pdb")).coords
    d, _ = cKDTree(c64).query(c64, k=4)
    hist = np.loadtxt(f("hist.txt"))
    want, _ = np.histogram(d[:, 1:].ravel(), bins=200)
    q["pdb_hist_diff"] = int(np.abs(hist[:, 1] - want).sum())
    lab_vol = np.full((64, 64, 64), 2.5, np.float32)
    save_image(f("lab.vol"), lab_vol)
    run("pdb_label_from_volume", "pdb_label_from_volume", [
        "--pdb", f("model.pdb"), "--vol", f("lab.vol"), "-o", f("lab.pdb"),
        "--origin", 32, 32, 32, "--sampling", 1.0, "--md", f("lab.xmd")])
    occ = np.asarray(read_pdb(f("lab.pdb")).occupancies)
    inside = np.abs(c64).max(axis=1) < 30      # atoms inside the box
    q["pdb_label_err"] = float(np.abs(occ[inside] - 2.5).max())
    run("pdb_reduce_pseudoatoms", "pdb_reduce_pseudoatoms", [
        "-i", f("model.pdb"), "-o", f("reduced.pdb"), "--num", 50])
    q["pdb_reduced_atoms"] = len(read_pdb(f("reduced.pdb")))
    MetaData.fromRows([{"sphCoefficients": np.zeros(3 * 13)}]).write(
        f("clnm0.xmd"))
    run("pdb_sph_deform", "pdb_sph_deform", [
        "--pdb", f("model.pdb"), "-o", f("deformed.pdb"), "--clnm",
        f("clnm0.xmd"), "--boxsize", 64, "--sr", 1.0])
    q["pdb_deform_zero_A"] = float(np.abs(read_pdb(f("deformed.pdb")).coords
                                          - c64).max())
    run("pdb_center", "pdb_center", ["-i", f("model.pdb"),
                                     "-o", f("centered.pdb")])
    q["pdb_center_A"] = float(np.abs(read_pdb(f("centered.pdb")).coords
                                     .mean(axis=0)).max())
    run("pdb_select", "pdb_select", ["-i", f("model.pdb"),
                                     "-o", f("selected.pdb"), "--atom", "N"])
    q["pdb_selected"] = len(read_pdb(f("selected.pdb")))
    q["pdb_selected_want"] = int(sum(e == "N" for e in model.elements))

    # (b4) a micrograph: coordinates, noisy zones, preprocessing,
    # extraction
    t0 = time.perf_counter()
    mics, xy, _ = picking_micrographs(n, mic_size, mic_views(mic_size, n),
                                      seed + 1, device)
    mic = mics[0]
    band = mic_size // 8
    mic[:, -band:] *= 6.0               # a noisy band on the right
    save_image(f("mic.mrc"), mic)
    pos = xy[0]
    MetaData.fromRows({"xcoor": int(x), "ycoor": int(y), "itemId": i + 1}
                      for i, (x, y) in enumerate(pos)).write(f("pos.xmd"))
    # three pickers: all, the first two thirds jittered, the last two thirds
    k3 = len(pos) // 3
    MetaData.fromRows({"xcoor": int(x) + 2, "ycoor": int(y) - 1}
                      for x, y in pos[:2 * k3]).write(f("pick2.xmd"))
    np.savetxt(f("pick3.txt"), pos[k3:], fmt="%d")
    with open(f("pickers.txt"), "w") as fh:
        fh.write("\n".join([f("pos.xmd"), f("pick2.xmd"), f("pick3.txt")]))
    MetaData.fromRows([{"micrograph": f("mic.mrc"),
                        "coordinates": f("pos.xmd"),
                        "ctfModel": f("group0.ctfparam")}]).write(
        f("mics.xmd"))
    q["data_s"] += time.perf_counter() - t0
    run("coordinates_noisy_zones_filter", "coordinates_noisy_zones_filter", [
        "--pos", f("pos.xmd"), "--mic", f("mic.mrc"), "-o", f("zones.xmd"),
        "--patchSize", n, "--zmax", 3])
    kept = {r["itemId"] for r in md_rows(f("zones.xmd"))}
    in_band = {i + 1 for i, (x, _) in enumerate(pos)
               if x >= mic_size - band + n // 2}
    clear = {i + 1 for i, (x, _) in enumerate(pos)
             if x < mic_size - band - n // 2}
    q["zones"] = {"band_removed": len(in_band - kept) / max(len(in_band), 1),
                  "clear_kept": len(clear & kept) / max(len(clear), 1)}
    run("coordinates_consensus", "coordinates_consensus", [
        "-i", f("pickers.txt"), "-s", n, "-c", 2, "-o", f("cons.xmd")])
    got = np.array([(r["xcoor"], r["ycoor"]) for r in md_rows(f("cons.xmd"))])
    q["consensus_picks"] = {"found": len(got), "want": len(pos)}
    run("pick_noise", "pick_noise", ["-i", f("mic.mrc"), "-c", f("pos.xmd"),
                                     "-o", f("noise.xmd"), "-s", n, "-n",
                                     200, "--seed", seed])
    nz = np.array([(r["xcoor"], r["ycoor"]) for r in md_rows(f("noise.xmd"))])
    dmin = np.hypot(nz[:, None, 0] - pos[None, :, 0],
                    nz[:, None, 1] - pos[None, :, 1]).min()
    q["pick_noise"] = {"picked": len(nz), "min_dist_box": float(dmin / n)}
    run("preprocess_mics", "preprocess_mics", [
        "-i", f("mics.xmd"), "-s", TL_WIENER_TS, "-o", f("pre"), "-d", 2,
        "--invert_contrast", "--phase_flip"])
    # numpy: phase flip by the CTF's sign, the centred crop of the full
    # spectrum to half the size, contrast inverted, normalised
    ctf0 = CTFDescription.from_metadata(f("group0.ctfparam"))
    fy = np.fft.fftfreq(mic_size)[:, None] / ctf0.sampling_rate
    fx = np.fft.rfftfreq(mic_size)[None, :] / ctf0.sampling_rate
    sgn = np.sign(ctf0.pure_at(fx.astype(np.float32), fy.astype(np.float32),
                               damped=False, device="cpu").numpy())
    flipped = np.fft.irfft2(np.fft.rfft2(mic.astype(np.float64)) * sgn,
                            s=mic.shape)
    h = mic_size // 2
    spec = np.fft.fftshift(np.fft.fft2(flipped))
    lo_ = mic_size // 2 - h // 2
    crop = spec[lo_:lo_ + h, lo_:lo_ + h]
    want = -np.fft.ifft2(np.fft.ifftshift(crop)).real * (h * h) \
        / mic_size ** 2
    want = (want - want.mean()) / want.std()
    q["preprocess_vs_numpy"] = float(np.abs(load("pre/mic.mrc") - want).max()
                                     / np.abs(want).max())
    run("extract_particles", "extract_particles", [
        "-i", f("mics.xmd"), "-s", n, "-o", f("ex")])
    ex = np.asarray(Image.read_stack(f("ex/mic_particles.mrcs")))
    exr = md_rows(f("ex/particles.xmd"))
    crops = np.stack([mic[r["ycoor"] - n // 2:r["ycoor"] + n // 2,
                          r["xcoor"] - n // 2:r["xcoor"] + n // 2]
                      for r in exr])
    q["extract"] = {"boxes": len(exr), "want": len(pos),
                    "differ": int((ex != crops).sum())}
    sel = root / "sel"
    sel.mkdir()
    for k in range(3):
        _shutil.copy(f("grey.mrcs"), str(sel / f"s{k}.mrcs"))
    run("metadata_selfile_create", "metadata_selfile_create", [
        "-p", str(sel / "*.mrcs"), "-o", f("sel.xmd"), "-s"])
    hdr = Image()
    hdr.read(str(sel / "s0.mrcs"), header_only=True)
    q["selfile_rows"] = {"got": len(md_rows(f("sel.xmd"))),
                         "want": 3 * hdr.header.shape[0]}
    run("metadata_xml", "metadata_xml", ["-i", f("ex/particles.xmd"),
                                         "-o", f("parts.xml"),
                                         "--extractParticlesMD"])
    q["xml_coordinates"] = open(f("parts.xml")).read().count("<coordinate ")

    # (b5) views at n: swiftalign, align_pca_2d, cl2d_clustering,
    # metadata_split_3D
    t0 = time.perf_counter()
    dirs = rng.uniform(0, 1, (TL_DIRS, 2))
    drot = 360 * dirs[:, 0]
    dtilt = np.degrees(np.arccos(1 - 2 * dirs[:, 1]))
    lab = rng.integers(0, TL_DIRS, views)
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-2, 2, (2, views))
    clean = projections(n, drot[lab], dtilt[lab], psi, sx, sy,
                        scaled_blobs(BLOBS8, n), device=device)
    sig = float(clean.std())
    noisy = clean + np.float32(0.5 * sig) * rng.standard_normal(
        clean.shape, dtype=np.float32)
    dfu = rng.uniform(8000, 20000, views)
    sw_md = write_stack_md(root, "sw", noisy, {
        "anglePsi": psi, "shiftX": sx, "shiftY": sy,
        "ctfDefocusU": dfu, "ctfDefocusV": dfu + 300, "ctfDefocusAngle":
        rng.uniform(0, 180, views), "ctfVoltage": np.full(views, 300.0)})
    one = projections(n, np.full(views, 30.0), np.full(views, 60.0), psi,
                      sx, sy, scaled_blobs(BLOBS8, n), device=device)
    one_noisy = one + np.float32(0.5 * float(one.std())) * \
        rng.standard_normal(one.shape, dtype=np.float32)
    save_image(f("one.mrcs"), one_noisy)
    ref_view = projections(n, np.array([30.0]), np.array([60.0]),
                           np.zeros(1), np.zeros(1), np.zeros(1),
                           scaled_blobs(BLOBS8, n), device=device)[0]
    avg_lab = np.repeat(np.arange(TL_DIRS), TL_AVG_COPIES)
    base = projections(n, drot, dtilt, np.zeros(TL_DIRS), np.zeros(TL_DIRS),
                       np.zeros(TL_DIRS), scaled_blobs(BLOBS8, n),
                       device=device)
    avgs = base[avg_lab] + np.float32(0.1 * sig) * rng.standard_normal(
        (len(avg_lab), n, n), dtype=np.float32)
    save_image(f("avgs.mrcs"), avgs)
    q["data_s"] += time.perf_counter() - t0
    run("swiftalign_wiener_2d", "swiftalign_wiener_2d", [
        "-i", sw_md, "-o", f("sw_wiener.mrcs"), "--sampling", 2.0, "--wc",
        0.1])
    wien = np.asarray(Image.read_stack(f("sw_wiener.mrcs")))
    # numpy: the first 16 rows' Wiener filters
    wrows = md_rows(sw_md)[:16]
    err = 0.0
    for i, r in enumerate(wrows):
        ctf = CTFDescription(sampling_rate=2.0, voltage=300.0,
                             defocusU=r["ctfDefocusU"],
                             defocusV=r["ctfDefocusV"],
                             azimuthal_angle=r["ctfDefocusAngle"], Cs=2.7,
                             Q0=0.07)
        c = ctf.generate_2d(n, n, device="cpu").numpy().astype(np.float64)
        w = np.fft.irfft2(np.fft.rfft2(noisy[i]) * c / (c * c + 0.1),
                          s=(n, n))
        err = max(err, float(np.abs(wien[i] - w).max() / np.abs(w).max()))
    q["wiener2d_vs_numpy"] = err
    run("swiftalign_classification", "swiftalign_aligned_2d_classification", [
        "-i", sw_md, "-o", f("swc"), "--nClasses", TL_DIRS])
    got = np.array([r["ref"] for r in md_rows(f("swc/classes.xmd"))])
    q["swift_purity"] = class_purity(got - 1, lab)[0]
    run("cl2d_clustering", "cl2d_clustering", [
        "-i", f("avgs.mrcs"), "-o", f("cl"), "-m", TL_DIRS - 4, "-M",
        TL_DIRS + 4])
    got = np.array([r["ref"] for r in md_rows(f("cl/clusters.xmd"))])
    q["cl2d_clusters"] = int(got.max())
    q["cl2d_purity"] = class_purity(got - 1, avg_lab)[0]
    run("align_pca_2d", "align_pca_2d", ["-i", f("one.mrcs"), "-o",
                                         f("pca"), "--iter", 3,
                                         "--ncomp", 5])
    # the average is in the frame of the set's first average: registered
    # to the clean view before the correlation
    from xmipp3_tpu_torch.ops.align import iterative_align
    al = iterative_align(ref_view, load("pca/average.mrc")[None],
                         device=device)[4]
    q["pca_avg_corr"] = real_corr(al[0].cpu().numpy(), ref_view)
    save_image(f("one_few.mrcs"), one_noisy[:200])
    run("alignPCA_2D", "alignPCA_2D", ["-i", f("one_few.mrcs"), "-o",
                                       f("pca_alias"), "--iter", 1,
                                       "--ncomp", 2])
    q["pca_alias_rows"] = len(md_rows(f("pca_alias/pca.xmd")))
    eig = np.asarray(Image.read_stack(f("pca/eigenimages.mrcs")))
    q["pca_eigen_finite"] = bool(np.isfinite(eig).all() and eig.shape[0] == 5)
    split_md = write_stack_md(root, "split", noisy[:500], {
        "angleRot": drot[lab[:500]], "angleTilt": dtilt[lab[:500]],
        "imageIndex": lab[:500], "maxCC": rng.uniform(0, 1, 500)})
    run("metadata_split_3D", "metadata_split_3D", [
        "-i", split_md, "--oroot", f("split"), "--angSampling", 15])
    up, lo = (md_rows(f(f"split_{s}.xmd")) for s in ("upper", "lower"))
    q["split_rows"] = len([r for r in up + lo if r.get("image")])

    # (b6) graph_max_cut on two planted communities
    g = TL_GRAPH
    side = np.arange(g) % 2
    W = np.where(side[:, None] != side[None, :], rng.uniform(0.6, 1.0, (g, g)),
                 rng.uniform(0.0, 0.4, (g, g)))
    W = 0.5 * (W + W.T)
    np.fill_diagonal(W, 0.0)
    np.savetxt(f("w.txt"), W, fmt="%.6f")
    run("graph_max_cut", "graph_max_cut", ["-i", f("w.txt"),
                                           "-o", f("cut.txt")])
    cut = np.loadtxt(f("cut.txt")).astype(int)
    q["maxcut_agree"] = float(max((cut == side).mean(), (cut != side).mean()))

    # (b7) matlab_bridge: every function
    bridge = []
    img = noisy[0].astype(np.float64)
    vol64 = vs.astype(np.float64)
    ctf_st = {"DeltafU": 12000.0, "DeltafV": 11000.0, "AzimuthalAngle": 30.0,
              "kV": 300.0, "Cs": 2.0, "Q0": 0.1, "K": 1.0,
              "objectPixelSize": 2.0}
    big2 = np.asarray(Image.read_stack(f("avgs.mrcs")))[0]
    img128 = np.kron(big2, np.ones((2, 2))).astype(np.float64)
    nma = root / "nma"
    nma.mkdir()
    MetaData.fromRows({"image": f"{k + 1}@s.mrcs",
                       "nmaDisplacements": np.array([0.5 * k, -k, 2.0]),
                       "cost": 0.1 * k} for k in range(4)).write(
        str(nma / "images.xmd"))
    psd = np.abs(np.fft.fftshift(np.fft.fft2(img128))) ** 2
    args = {
        "read": dict(filename=f("set_ref.vol")),
        "write": dict(array=vol64, filename=f("bridge_w.vol")),
        "rotate": dict(img=img128, angs=33.0, axis=[], align_z=[],
                       gridding=False, wrap=True),
        "scale": dict(img=vol64, outsize=[48, 48, 48], gridding=True),
        "scale_pyramid": dict(img=img128, operation="reduce", levels=1),
        "mirror": dict(img=vol64, flipstring="xz"),
        "mirt3D_mexinterp": dict(input_image=vol64,
                                 XI=rng.uniform(1, 64, 100),
                                 YI=rng.uniform(1, 64, 100),
                                 ZI=rng.uniform(1, 64, 100)),
        "mask": dict(msize=[64, 64, 64], type="circular", params=[20.0],
                     inner=False),
        "morphology": dict(img=(img128 > img128.mean()).astype(float),
                           operation="opening", neig=8, ksize=1, count=0),
        "normalize": dict(img=img128 + 3, method="NewXmipp", mask=[]),
        "adjust_ctf": None,
        "ctf_correct_phase": dict(img=img128, st=ctf_st, method="leave",
                                  epsilon=0.0),
        "psd_enhance": dict(img=psd, center=True, take_log=True,
                            filter_w1=0.05, filter_w2=0.2, decay_width=0.02,
                            mask_w1=0.025, mask_w2=0.2),
        "periodogram": dict(image=mic[:mic_size // 4, :mic_size // 4],
                            sz=256),
        "ctf_generate_filter": dict(Xdim=128, Tm=2.0, DeltafU=12000.0,
                                    DeltafV=10000.0, AzimuthalAngle=15.0,
                                    kV=300.0, Cs=2.0, Q0=0.1, K=1.0),
        "align2d": dict(img=np.roll(img128, (3, -2), (0, 1)), ref=img128,
                        mode="complete", max_shift=8, Rin=2, Rout=60),
        "resolution": dict(img=img128, ref=np.kron(
            np.asarray(Image.read_stack(f("avgs.mrcs")))[1],
            np.ones((2, 2))), objectpixelsize=2.0),
        "volume_segment": dict(vol=vol64, sampling=1.0, mass=20000.0,
                               type="voxels", enable_threshold=False),
        "read_metadata": dict(filename=f("pos.xmd")),
        "nma_read_alignment": dict(NMAdirectory=str(nma)),
        "nma_save_cluster": dict(NMAdirectory=str(nma), clusterName="c1",
                                 inCluster=[1.0, 0.0, 1.0, 1.0]),
        "read_structure_factor": dict(rundir=f("sf.xmd")),
    }
    MetaData.fromRows({"resolutionFreq": 0.01 * (k + 1),
                       "resolutionLogStructure": -0.1 * k}
                      for k in range(40)).write(f("sf.xmd"))
    # adjust_ctf on a planted 256^2 PSD (1.5 A/px, defocus 15,000 /
    # 14,000 A at 20 degrees)
    Ts = 1.5
    true = CTFDescription(sampling_rate=Ts, voltage=300, Cs=2.7, Q0=0.07,
                          defocusU=15000, defocusV=14000,
                          azimuthal_angle=20.0, K=1.0)
    fy = np.fft.fftfreq(256).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(256).astype(np.float32)[None, :] / Ts
    half = true.pure_at(fx, fy, device="cpu").numpy() ** 2 + 0.05
    full = np.concatenate([half, half[:, -2:0:-1]], axis=1)[:, :256]
    args["adjust_ctf"] = dict(psd=np.fft.fftshift(full), Dz=14000.0,
                              voltage=300.0, objectPixelSize=Ts,
                              ctfmodelSize=0, Cs=2.7, min_freq=0.03,
                              max_freq=0.35, Ca=2.0)
    finite = {}
    for func, a_ in args.items():
        fin, fout = f(f"bridge_{func}_in.mat"), f(f"bridge_{func}.mat")
        savemat(fin, a_)
        run(f"bridge_{func}", "matlab_bridge", ["--func", func, "-i", fin,
                                                "-o", fout])
        out = loadmat(fout, squeeze_me=True)
        finite[func] = all(np.isfinite(np.asarray(v, np.float64)).all()
                           for k, v in out.items() if not k.startswith("__")
                           and np.asarray(v).dtype.kind in "fiu"
                           and func != "mirt3D_mexinterp")
        bridge.append((func, fin, fout))
    q["bridge_finite"] = finite
    out = loadmat(f("bridge_adjust_ctf.mat"), squeeze_me=True)
    q["bridge_defocus_err"] = float(max(
        abs(float(out["DeltafU"]) - 15000) / 15000,
        abs(float(out["DeltafV"]) - 14000) / 14000))

    # (b8) infra: the example modules, and a user program built against
    # the native library where g++ is present
    import contextlib
    import io as _io
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        run("test_script_importing_module", "test_script_importing_module",
            [])
    printed = buf.getvalue().splitlines()
    log("\n".join(ln for ln in printed if not ln.startswith("[")))
    q["import_ok"] = "[       OK ] test_script_importing_module" in printed
    if _shutil.which("g++") and _shutil.which("make"):
        with open(f("hello.cpp"), "w") as fh:
            fh.write('#include <cstdio>\nextern "C" int mrc_read_slices('
                     'const char*, const long*, long, float*, int);\n'
                     'int main() { std::printf("%d\\n", mrc_read_slices('
                     '"none.mrc", nullptr, 0, nullptr, 1) != 0); }\n')
        with contextlib.redirect_stdout(_io.StringIO()):
            run("compile", "compile", ["-i", f("hello.cpp"),
                                       "-o", f("hello")])
        out = subprocess.run([f("hello")], capture_output=True, text=True,
                             timeout=60)
        q["compile_ok"] = out.returncode == 0 and out.stdout.strip() == "1"
    return q, bridge


def card_against_cpu(root: Path, models) -> dict:
    """Each trained model's predictions on the card against the port's CPU
    forward on the same weights and inputs: max |card - CPU| / max |CPU|."""
    from xmipp3_tpu_torch.models import deep
    out = {}
    for label, (fn, kind, n_out, X) in models.items():
        m = deep.KINDS[kind](**({} if n_out is None else {"n_out": n_out}))
        deep.load_params(str(root / fn), m)
        card = deep.predict(m, X, device=DEVICE)
        cpu = deep.predict(m, X, device="cpu")
        out[label] = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    return out


def bridge_against_cpu(bridge) -> dict:
    """The bridge functions that run on the card, again with --device cpu:
    max |card - CPU| / max |CPU| over their float outputs (align2d: the
    largest difference of psi in degrees and of the shifts in px)."""
    from scipy.io import loadmat
    from xmipp3_tpu_torch.programs import get_program
    out = {}
    for func, fin, fout in bridge:
        if func not in TL_DEVICE_BRIDGE:
            continue
        fcpu = fout.replace(".mat", "_cpu.mat")
        rc = get_program("matlab_bridge").run_with_args(
            ["--func", func, "-i", fin, "-o", fcpu, "--device", "cpu",
             "-v", "0"])
        check(rc == 0, f"phase 17 bridge {func} on the CPU: rc {rc}")
        a, b = (loadmat(x, squeeze_me=True) for x in (fout, fcpu))
        if func == "align2d":
            out[func] = max(abs(float(a[k]) - float(b[k]))
                            for k in ("Psi", "Xoff", "Yoff"))
            continue
        err = 0.0
        for k, v in b.items():
            v = np.asarray(v)
            if k.startswith("__") or v.dtype.kind not in "fc":
                continue
            err = max(err, float(np.abs(np.asarray(a[k]) - v).max()
                                 / max(np.abs(v).max(), 1e-30)))
        out[func] = err
    return out


def tail(seed, root: Path):
    """Phase 17 in root: the 39 endpoints of the long tail through their
    CLI on the card but sync_data (a network fetch) and compile (run when
    the host has g++): the deep programs train and score held-out data,
    then their models' predictions on the card are held against the
    port's CPU forward; the other programs against numpy or their planned
    limits; every matlab_bridge function, those that run on the card also
    against its CPU run. No kernel may launch in it."""
    from xmipp3_tpu_torch.core import timing
    root.mkdir(parents=True)
    report = {}
    limit = Limits(17)

    def run(label, name, args):
        prog = run_program(17, report, label, name, args)
        check(not report[label]["launches"], f"phase 17 {label}: launched "
              f"{report[label]['launches']}, expected no kernel")
        return prog

    start = time.perf_counter()
    timing.enable_timing(True)
    (root / "deep").mkdir()
    (root / "misc").mkdir()
    try:
        qa, models = tail_deep_readings(seed, root / "deep", run, DEVICE)
        qb, bridge = tail_misc_readings(seed, root / "misc", run, DEVICE)
    finally:
        timing.take_timing()
        timing.enable_timing(False)
    t0 = time.perf_counter()
    cpu = card_against_cpu(root / "deep", models)
    bcpu = bridge_against_cpu(bridge)
    report["checks_s"] = time.perf_counter() - t0
    q = {**qa, **qb, "data_s": qa["data_s"] + qb["data_s"],
         "card_vs_cpu": cpu, "bridge_card_vs_cpu": bcpu}
    report["quality"] = q
    report["phase_s"] = time.perf_counter() - start
    log(f"  phase 17 took {report['phase_s']:.2f} s")
    log("tail " + json.dumps(report))
    L = TL_LIMITS
    for k, v in cpu.items():
        limit(v <= TL_TOL, f"phase 17 {k}: card {v:.2e} off the CPU forward")
    for k, v in bcpu.items():
        limit(v <= (0.05 if k == "align2d" else TL_TOL),
              f"phase 17 bridge {k}: card {v:.2e} off the CPU")
    for k in ("consensus_acc", "cleaner_acc", "misalign_acc", "hand_p",
              "post_corr", "swift_purity", "cl2d_purity", "pca_avg_corr",
              "maxcut_agree", "wiener_corr", "consensus_corr"):
        limit(q[k] >= L[k], f"phase 17 {k}: {q[k]:.4f} (limit {L[k]})")
    limit(q["hand_p_mirror"] <= L["hand_p_mirror"], f"phase 17 hand: "
          f"mirror {q['hand_p_mirror']:.4f} (limit {L['hand_p_mirror']})")
    for k in ("ga_median_err_deg", "deepres_err_A", "grey_err",
              "volumeset_err_deg", "bridge_defocus_err"):
        limit(q[k] <= L[k], f"phase 17 {k}: {q[k]:.4g} (limit {L[k]})")
    limit(q["post_corr"] > q["post_input_corr"], f"phase 17 postprocessing: "
          f"{q['post_corr']:.4f} against the input's "
          f"{q['post_input_corr']:.4f}")
    limit(q["wiener_corr"] > q["wiener_group_corr"], f"phase 17 wiener3d: "
          f"{q['wiener_corr']:.4f} against the best group's "
          f"{q['wiener_group_corr']:.4f}")
    limit(q["compare_density"]["positive"] >= L["compare_positive"],
          f"phase 17 compare_density: {q['compare_density']}")
    limit(q["pdb_hist_diff"] == 0 and q["pdb_label_err"] <= 1e-2
          and q["pdb_reduced_atoms"] == 50 and q["pdb_deform_zero_A"]
          <= 1e-3 and q["pdb_center_A"] <= 1e-2
          and q["pdb_selected"] == q["pdb_selected_want"],
          "phase 17 pdb programs: " + json.dumps(
              {k: v for k, v in q.items() if k.startswith("pdb_")}))
    limit(q["zones"]["band_removed"] >= L["zones_band_removed"]
          and q["zones"]["clear_kept"] >= L["zones_clear_kept"],
          f"phase 17 noisy zones: {q['zones']}")
    limit(q["consensus_picks"]["found"] == q["consensus_picks"]["want"],
          f"phase 17 coordinates_consensus: {q['consensus_picks']}")
    limit(q["pick_noise"]["picked"] == 200
          and q["pick_noise"]["min_dist_box"] >= 1.5,
          f"phase 17 pick_noise: {q['pick_noise']}")
    limit(q["preprocess_vs_numpy"] <= TL_TOL, f"phase 17 preprocess_mics: "
          f"{q['preprocess_vs_numpy']:.2e} off numpy")
    limit(q["extract"]["differ"] == 0 and q["extract"]["boxes"]
          == q["extract"]["want"], f"phase 17 extract_particles: "
          f"{q['extract']}")
    limit(q["wiener2d_vs_numpy"] <= TL_TOL, f"phase 17 swiftalign_wiener_"
          f"2d: {q['wiener2d_vs_numpy']:.2e} off numpy")
    limit(q["selfile_rows"]["got"] == q["selfile_rows"]["want"]
          and q["xml_coordinates"] == q["extract"]["boxes"]
          and q["split_rows"] > 0 and q["pca_eigen_finite"]
          and q["import_ok"] and q.get("compile_ok", True)
          and q["deepres_alias_same"] and q["pca_alias_rows"] == 200
          and all(q["bridge_finite"].values()),
          "phase 17 host programs: " + json.dumps(
              {k: q.get(k) for k in ("selfile_rows", "xml_coordinates",
                                     "split_rows", "pca_eigen_finite",
                                     "import_ok", "compile_ok",
                                     "deepres_alias_same", "pca_alias_rows",
                                     "bridge_finite")}))
    limit.check()


# ---------------------------------------------------------------------------
# phase 18: the binding surface (xmippLib, xmipp_base, xmippPyModules) as a
# Scipion protocol drives it, in this process and in a script of its own
# ---------------------------------------------------------------------------

BD_DOUBLE = 16                 # projectVolumeDouble's gallery directions
BD_GEO_ROWS = 1000             # readApplyGeo: rows of phase 4's assignment
BD_CTF_STEP = VIEWS // CTF_GROUPS   # applyCTF: a row of each micrograph
BD_PAIRS = 64                  # image_align: phase 7's planted pairs
BD_MIC = "micrograph_A.mrc"    # phase 8's micrograph A, kept by phase 8
BD_PREVIEW = 512               # the preview filters' dim
BD_FILTERS = (("bandPassFilter", (0.02, 0.2, 0.02)),
              ("gaussianFilter", (0.1,)), ("realGaussianFilter", (1.0,)),
              ("badPixelFilter", (3.0,)),
              ("fastEstimateEnhancedPSD", (1.0,)))
BD_SWIFT = (64, 2000, 16)      # swiftalign's views: n, count, directions
BD_BNB = (4, (0.0, 360.0, 30.0), (1.0, 1.0))   # bands, angles, shifts
BD_TOL = 1e-5                  # the binding against the port's batched ops
BD_CPU_TOL = 1e-4              # the card against device="cpu"
BD_CPU_THREADS = 4             # the device="cpu" runs' share of 8 cores
BD_SAME = 0.99                 # labels and matches the card shares with the
#                                CPU (a near tie may fall either way)
BD_SITE = ROOT / "xmipp3_tpu_torch" / "binding" / "site"
BD_SCRIPT = '''"""A Scipion-style script: an XmippScript projecting a volume through
xmippLib, run with the port's binding/site ahead on PYTHONPATH."""
import json
import sys

import xmippLib
import xmipp_base


class ProjectVolume(xmipp_base.XmippScript):
    def defineParams(self):
        self.addUsageLine("Project a volume at one direction")
        self.addParamsLine(" -i <volume> : the volume")
        self.addParamsLine(" -o <image> : its projection")
        self.addParamsLine(" --rot <rot> : first Euler angle")
        self.addParamsLine(" --tilt <tilt> : second Euler angle")
        self.addParamsLine(" --psi <psi> : third Euler angle")

    def readParams(self):
        self.vol, self.out = self.getParam("-i"), self.getParam("-o")
        self.angles = [self.getDoubleParam(p)
                       for p in ("--rot", "--tilt", "--psi")]

    def run(self):
        projector = xmippLib.FourierProjector(xmippLib.Image(self.vol))
        projector.projectVolume(*self.angles).write(self.out)
        print("device", projector._p.vf.device.type)


rc = ProjectVolume().tryRun()
names = ("jax", "xmipp3_tpu", "xmippLib", "xmipp_base", "xmippPyModules")
print("modules", json.dumps({
    m: getattr(sys.modules[m], "__file__", None) for m in sorted(sys.modules)
    if m.split(".")[0] in names}))
sys.exit(rc)
'''


def swift_views(n: int, views: int, dirs: int, seed: int, device):
    """Phase 17's swiftalign recipe: noisy views of `dirs` directions of
    BLOBS8 at n with psi uniform and shifts in +-2 px (numpy's draws, the
    views made on `device`). Returns (views, psi, sx, sy, refs), refs the
    clean view of each direction (bnb_gpu's references)."""
    rng = np.random.default_rng(seed + 18)
    d = rng.uniform(0, 1, (dirs, 2))
    rot, tilt = 360 * d[:, 0], np.degrees(np.arccos(1 - 2 * d[:, 1]))
    lab = rng.integers(0, dirs, views)
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-2, 2, (2, views))
    blobs = scaled_blobs(BLOBS8, n)
    clean = projections(n, rot[lab], tilt[lab], psi, sx, sy, blobs,
                        device=device)
    noisy = clean + np.float32(0.5 * float(clean.std())) * \
        rng.standard_normal(clean.shape, dtype=np.float32)
    zero = np.zeros(dirs)
    refs = projections(n, rot, tilt, zero, zero, zero, blobs, device=device)
    return noisy, psi, sx, sy, refs


def swift_pass(views, psi, sx, sy, refs, seed, device, run):
    """Phase 18's swiftalign and bnb_gpu calls on `device`, each through
    run(label, fn): the affine matrices and warp, InPlaneTransformCorrector,
    a CTF image, aligned_2d_classification of the registered views into
    len(refs) classes, and bnb_gpu's band projections of refs on its trial
    grid, the views' bands and their match."""
    from xmipp3_tpu_torch.binding.xmippPyModules.classifyPcaFuntion import \
        bnb_gpu
    from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign import (
        alignment, classification, ctf, transform)
    out = {}
    out["A"] = run("affine_matrix_2d", lambda: transform.affine_matrix_2d(
        psi, np.stack([sx, sy], 1), device=device))
    out["warped"] = run("affine_2d", lambda: transform.affine_2d(
        views, out["A"], device=device))
    out["reg"] = run("InPlaneTransformCorrector", lambda: (
        alignment.InPlaneTransformCorrector(device=device)(views, psi, sx,
                                                           sy)))
    out["ctfs"] = run("compute_ctf_image_2d", lambda: (
        ctf.compute_ctf_image_2d(15000.0, 14000.0, 30.0, views.shape[-1],
                                 2.0, device=device)))
    out["cls"] = run("aligned_2d_classification", lambda: (
        classification.aligned_2d_classification(
            out["reg"], n_classes=len(refs), seed=seed, device=device)))
    bnb = bnb_gpu.BnBgpu(BD_BNB[0], device=device)
    bnb.setRotAndShift(*BD_BNB[1:])
    out["bands"] = run("precalculate_projection",
                       lambda: bnb.precalculate_projection(refs))
    out["exp"] = run("create_batchExp", lambda: bnb.create_batchExp(views))
    out["match"] = run("match_batch",
                       lambda: bnb.match_batch(out["exp"], out["bands"]))
    return out


def binding_on_cpu(mic: Path, swift, seed):
    """The device="cpu" runs that phase 18 holds the card against (a worker
    thread runs them while the card's calls go on): the preview filters of
    the micrograph and swift_pass on the views, on BD_CPU_THREADS of the
    host's cores (the rest are the card's calls' and the script's)."""
    import torch
    from xmipp3_tpu_torch.binding import xmippLib as xl
    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(BD_CPU_THREADS)
    try:
        previews = {}
        for name, args in BD_FILTERS:
            img = xl.Image()
            getattr(xl, name)(img, str(mic), *args, BD_PREVIEW, device="cpu")
            previews[name] = img.getData()
        out = {"previews": previews, "previews_s": time.perf_counter() - t0}
        out["swift"] = swift_pass(*swift, seed, "cpu",
                                  lambda label, fn: fn())
    finally:
        torch.set_num_threads(threads)
    out["wall_s"] = time.perf_counter() - t0
    return out


def binding_surface(seed, root: Path, cycle: Path, ctf_dir: Path,
                    mic: Path):
    """Phase 18 in root: the port's binding driven as a Scipion protocol
    drives it, on phase 4's phantom, gallery directions and assignment
    (in cycle), phase 6's CTF views (in ctf_dir) and phase 8's micrograph
    A (mic); a script run with binding/site on PYTHONPATH at the same
    time. No kernel may launch."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from xmipp3_tpu_torch.binding import xmippLib as xl
    from xmipp3_tpu_torch.core.filename import FileName
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.ops.align import align_considering_mirrors
    from xmipp3_tpu_torch.ops.ctf import CTFDescription, apply_ctf
    from xmipp3_tpu_torch.ops.geo import read_apply_geo
    from xmipp3_tpu_torch.ops.project import FourierProjector
    root.mkdir(parents=True)
    report, q = {}, {}
    limit = Limits(18)
    start = time.perf_counter()

    # the script starts first: its ~8 s to reach the card overlap the rest,
    # as the worker thread's CPU runs do
    vol_fn = cycle / "phantom.vol"
    gal = md_rows(cycle / "gallery.doc")
    rot, tilt, psi = (np.array([r.get(k, 0.0) for r in gal], np.float64)
                      for k in ("angleRot", "angleTilt", "anglePsi"))
    script = root / "project_volume.py"
    script.write_text(BD_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(BD_SITE)}
    proc = subprocess.Popen(
        [sys.executable, str(script), "-i", str(vol_fn), "-o",
         str(root / "script.xmp"), "--rot", str(rot[7]), "--tilt",
         str(tilt[7]), "--psi", str(psi[7])], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = ThreadPoolExecutor(1)

    def part(label, calls, fn):
        """Run fn() with the launch counts at 0: its wall, ms a call, the
        kernels it launched (none expected) and its peak device memory."""
        torch.cuda.synchronize()
        launch_counts(reset=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = report[label] = {
            "calls": calls, "wall_s": wall, "ms_per_call": 1e3 * wall / calls,
            "launches": {k: v for k, v in launch_counts().items() if v},
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  {label}: {calls} calls in {wall:.3f} s "
            f"({r['ms_per_call']:.3f} ms a call), peak "
            f"{r['peak_device_GB']:.2f} GB, launches {r['launches']}")
        check(not r["launches"], f"phase 18 {label}: launched "
              f"{r['launches']}, expected no kernel")
        return out

    try:
        # the device="cpu" runs go to the worker as soon as their data exist
        t0 = time.perf_counter()
        swift = swift_views(*BD_SWIFT, seed, DEVICE)
        q["swift_data_s"] = time.perf_counter() - t0
        on_cpu = pool.submit(binding_on_cpu, mic, swift, seed)

        # (a) FourierProjector: one projectVolume a gallery direction
        vol = xl.Image(str(vol_fn))
        proj = part("FourierProjector", 1, lambda: xl.FourierProjector(vol))
        views = part("projectVolume", len(rot), lambda: np.stack([
            proj.projectVolume(a, b, c).getData()
            for a, b, c in zip(rot, tilt, psi)]))
        batched = FourierProjector(np.squeeze(vol.getData()), 2.0, DEVICE)
        want = np.concatenate([
            batched.project_euler(rot[s:s + 256], tilt[s:s + 256],
                                  psi[s:s + 256]).cpu().numpy()
            for s in range(0, len(rot), 256)])
        q["projectVolume_vs_batched"] = max_rel(views, want)
        del batched, want
        pick = np.linspace(0, len(rot) - 1, BD_DOUBLE).astype(int)
        real = part("projectVolumeDouble", BD_DOUBLE, lambda: np.stack([
            xl.projectVolumeDouble(vol, rot[i], tilt[i], psi[i]).getData()
            for i in pick]))
        q["double_vs_fourier_corr_median"] = float(np.median(
            image_corrs(real, views[pick])))

        # (b) readApplyGeo on phase 4's assigned rows, applyCTF on phase 6's
        md = xl.MetaData(str(cycle / "assigned.xmd"))
        ids = list(md)[:BD_GEO_ROWS]
        geo = part("readApplyGeo", len(ids), lambda: np.stack([
            xl.Image().readApplyGeo(md.getValue("image", i), md, i)
            .getData() for i in ids]))
        rows = [md.getRow(i) for i in ids]
        stk = FileName(rows[0]["image"]).path
        imgs = Image.read_slices(stk, [FileName(r["image"]).slice_index - 1
                                       for r in rows])
        g = lambda k: np.array([float(r.get(k, 0.0) or 0.0) for r in rows])
        want = read_apply_geo(imgs, g("anglePsi"), g("shiftX"), g("shiftY"),
                              np.array([bool(r.get("flip", False))
                                        for r in rows]), device=DEVICE)
        q["readApplyGeo_vs_batched"] = max_rel(geo, want.cpu().numpy())
        crows = md_rows(ctf_dir / "true_model.xmd")[::BD_CTF_STEP]

        def apply_rows():
            out = []
            for k, r in enumerate(crows):
                img = xl.Image(r["image"])
                if k % 2:
                    xl.applyCTF(img, r["ctfModel"], CTF_TS)
                else:
                    img.applyCTF(r["ctfModel"], CTF_TS)
                out.append(img.getData())
            return np.stack(out)
        got = part("applyCTF", len(crows), apply_rows)
        descs = []
        for r in crows:
            descs.append(CTFDescription.from_metadata(r["ctfModel"]))
            descs[-1].sampling_rate = CTF_TS
        cimgs = Image.read_slices(
            FileName(crows[0]["image"]).path,
            [FileName(r["image"]).slice_index - 1 for r in crows])
        q["applyCTF_vs_batched"] = max_rel(
            got, apply_ctf(cimgs, descs, device=DEVICE).cpu().numpy())
        m0, m1 = crows[0]["ctfModel"], crows[len(crows) // 2]["ctfModel"]
        ctf_fns = part("ctf_errors_and_psf", 3, lambda: (
            xl.errorBetween2CTFs(m0, m1, 256), xl.errorMaxFreqCTFs2D(
                m0, m1, 256), xl.getPSF(m0, CTF_TS)))
        cpu_fns = (xl.errorBetween2CTFs(m0, m1, 256, device="cpu"),
                   xl.errorMaxFreqCTFs2D(m0, m1, 256, device="cpu"),
                   xl.getPSF(m0, CTF_TS, device="cpu"))
        q["ctf_errors_card_vs_cpu"] = max(
            max_rel(np.atleast_1d(a), np.atleast_1d(b))
            for a, b in zip(ctf_fns, cpu_fns))

        # (c) image_align on phase 7's planted pairs, read back against the
        # truth by registering each aligned image onto the clean view
        clean, pairs, _, _ = align2d_views(N, BD_PAIRS, seed, DEVICE)
        aligned = part("image_align", BD_PAIRS, lambda: np.stack([
            xl.image_align(clean, p).getData() for p in pairs]))
        rpsi, rsx, rsy, rflip, _, _ = align_considering_mirrors(
            clean, aligned, device=DEVICE)
        rpsi = (rpsi.cpu().numpy() + 180.0) % 360.0 - 180.0
        q["align_psi_within"] = float(np.mean(np.abs(rpsi)
                                              <= ALIGN_PSI_DEG))
        q["align_shift_median_px"] = float(np.median(np.hypot(
            rsx.cpu().numpy(), rsy.cpu().numpy())))
        q["align_mirror_right"] = float(1.0 - rflip.float().mean())

        # (d) the preview filters on phase 8's 4096^2 micrograph A and (e)
        # swiftalign and classifyPcaFuntion on 2,000 views at 64^2, then
        # the same on the CPU (run by the worker meanwhile)
        previews = {}
        for name, args in BD_FILTERS:
            previews[name] = xl.Image()
            f = getattr(xl, name)
            part(name, 1, lambda: f(previews[name], str(mic), *args,
                                    BD_PREVIEW))
        c = swift_pass(*swift, seed, DEVICE, lambda label, fn: part(
            label, 1, fn))
        t0 = time.perf_counter()
        cpu = on_cpu.result()
        report["cpu_side"] = {"wait_s": time.perf_counter() - t0,
                              "wall_s": cpu["wall_s"],
                              "previews_s": cpu["previews_s"]}
        q["preview_card_vs_cpu"] = {}
        for name, img in previews.items():
            want = cpu["previews"][name]
            check(img.getData().shape == want.shape
                  and np.isfinite(img.getData()).all(), f"phase 18 {name}: "
                  f"preview {img.getData().shape}, CPU {want.shape}")
            q["preview_card_vs_cpu"][name] = max_rel(img.getData(), want)
        h = cpu["swift"]
        q["swift_card_vs_cpu"] = {k: max_rel(c[k], h[k]) for k in (
            "A", "warped", "reg", "ctfs", "bands", "exp")}
        q["classes_same"] = float(np.mean(c["cls"][0] == h["cls"][0]))
        sign = np.sign((c["cls"][2] * h["cls"][2]).sum(0))
        q["swift_card_vs_cpu"]["pca"] = max_rel(c["cls"][2] * sign,
                                                h["cls"][2])
        whole = [k for k in range(len(swift[4])) if np.array_equal(
            c["cls"][0] == k, h["cls"][0] == k)]
        q["swift_card_vs_cpu"]["averages"] = max_rel(
            c["cls"][1][whole], h["cls"][1][whole]) if whole else np.inf
        q["match_same"] = float(np.mean((c["match"][0] == h["match"][0])
                                        & (c["match"][1] == h["match"][1])))
        q["swift_card_vs_cpu"]["match_dist"] = max_rel(c["match"][2],
                                                       h["match"][2])

        # (f) the script's result
        t0 = time.perf_counter()
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            raise SmokeFailure("phase 18 script: no exit in 300 s")
        report["script"] = {"wait_s": time.perf_counter() - t0,
                            "rc": proc.returncode}
        check(proc.returncode == 0, f"phase 18 script: rc {proc.returncode}"
              f"\n{out}\n{err}")
        lines = dict(ln.split(" ", 1) for ln in out.splitlines()
                     if ln.startswith(("device ", "modules ")))
        mods = json.loads(lines.get("modules", "{}"))
        q["script_device"] = lines.get("device", "").strip()
        q["script_foreign_modules"] = sorted(
            m for m, f in mods.items() if m.split(".")[0] in ("jax",
                                                             "xmipp3_tpu")
            or f is None or "xmipp3_tpu_torch" not in f)
        q["script_vs_in_process"] = max_rel(
            np.squeeze(Image(str(root / "script.xmp")).data), views[7])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        pool.shutdown(wait=True)
    report["phase_s"] = time.perf_counter() - start
    report["quality"] = q
    log(f"  phase 18 took {report['phase_s']:.2f} s")
    log("binding " + json.dumps(report))
    limit(q["projectVolume_vs_batched"] <= BD_TOL, "phase 18 projectVolume: "
          f"{q['projectVolume_vs_batched']:.2e} off the batched projector")
    limit(q["double_vs_fourier_corr_median"] >= ANG_REAL_CORR,
          f"phase 18 projectVolumeDouble: median correlation "
          f"{q['double_vs_fourier_corr_median']:.5f} (limit {ANG_REAL_CORR})")
    for k in ("readApplyGeo_vs_batched", "applyCTF_vs_batched",
              "script_vs_in_process"):
        limit(q[k] <= BD_TOL, f"phase 18 {k}: {q[k]:.2e}")
    limit(q["ctf_errors_card_vs_cpu"] <= BD_CPU_TOL, f"phase 18 CTF errors "
          f"and PSF: card {q['ctf_errors_card_vs_cpu']:.2e} off the CPU")
    limit(q["align_psi_within"] >= ALIGN_PSI_OK
          and q["align_shift_median_px"] <= ALIGN_SHIFT_MEDIAN_PX
          and q["align_mirror_right"] >= ALIGN_FLIP_OK,
          f"phase 18 image_align: psi within {ALIGN_PSI_DEG} deg for "
          f"{q['align_psi_within']:.4f}, median shift "
          f"{q['align_shift_median_px']:.3f} px, mirror right for "
          f"{q['align_mirror_right']:.4f}")
    for group in ("preview_card_vs_cpu", "swift_card_vs_cpu"):
        for k, v in q[group].items():
            limit(v <= BD_CPU_TOL, f"phase 18 {k}: card {v:.2e} off the CPU")
    limit(q["classes_same"] >= BD_SAME and q["match_same"] >= BD_SAME,
          f"phase 18: classes {q['classes_same']:.4f} and matches "
          f"{q['match_same']:.4f} the same on the card and the CPU")
    limit(q["script_device"] == "cuda" and not q["script_foreign_modules"],
          f"phase 18 script: device {q['script_device']!r}, foreign "
          f"modules {q['script_foreign_modules']}")
    limit.check()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--mesh-rank"]:
        return mesh_rank()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "xmipp3_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no xmipp3_tpu_torch package beside {ROOT}; run "
              "this script inside a checkout of the repo", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xmipp3_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    reports = _cuda_build.build()
    log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    warm_ranks()
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    root = ROOT / "chip_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        kernels = kernels_vs_plain(args.seed)
        launches, rec_md, serial_vol = end_to_end(args.seed, root / "e2e")
        cycle, match_args, clean, poses = matching_cycle(args.seed,
                                                         root / "cycle")
        launches.update({k: v for k, v in cycle.items()
                         if k not in launches})
        log("phase 5: the mesh paths, ranks of a gloo group on one card")
        launches["kb_scatter_3ch_slab"] = mesh_runs(root, rec_md, serial_vol,
                                                    match_args)
        log("phase 6: the CTF-corrected cycle")
        ctf_cycle(args.seed, root / "ctf", clean, poses, root / "cycle")
        log("phase 7: 2-D filter, normalise, align and geometry (BASELINE "
            "config 1)")
        align_2d(args.seed, root / "align2d")
        log("phase 8: CTF estimation from micrographs and PSDs (BASELINE "
            "config 2)")
        ctf_estimation(args.seed, root / "ctfest")
        log("phase 9: movie alignment and MonoRes (BASELINE config 5)")
        movie_monores(args.seed, root / "movie")
        log("phase 10: 2-D classification (BASELINE config 4's CL2D half)")
        ml2d_kernel = classify_2d(args.seed, root / "classify")
        log("phase 11: image and metadata utilities, ART/SIRT/WBP, "
            "align_significant and reconstruct_significant")
        art_kernels = utilities_and_reconstruction(
            args.seed, root / "recmisc", root / "e2e", root / "cycle", poses)
        log("phase 12: phantoms and projection, continuous and discrete "
            "angular assignment, class averages, subtraction, residuals, "
            "SSNR and common lines")
        angular_kernel = angular_slice(args.seed, root / "angular",
                                       root / "cycle", root / "ctf", poses)
        log("phase 13: image and class analysis (heterogeneity splits, "
            "halves restoration, symmetry, screening, dimension reduction, "
            "class analysis)")
        split_kernels = analysis(args.seed, root / "analysis",
                                 root / "cycle", root / "classify", clean,
                                 poses)
        log("phase 14: micrograph picking, the misc programs and the volume "
            "programs")
        misc_and_volumes(args.seed, root / "misc", root / "classify", clean,
                         poses)
        log("phase 15: Zernike3D and NMA flexibility (volumes, per-particle "
            "fits, NMA, subtomograms and ART)")
        flex_kernels = flexibility(args.seed, root / "flex")
        log("phase 16: tomography, the tail of flex_misc_ext and the tilt "
            "programs")
        tomo_kernels = tomography(args.seed, root / "tomo")
        log("phase 17: the long tail (deep programs, final_batch, "
            "scripts_misc, matlab_bridge, infra)")
        tail(args.seed, root / "tail")
        log("phase 18: the binding surface (xmippLib, xmipp_base, "
            "xmippPyModules) as a script drives it")
        binding_surface(args.seed, root / "binding", root / "cycle",
                        root / "ctf", root / BD_MIC)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    kernels.append(ml2d_kernel)
    kernels += art_kernels
    kernels.append(angular_kernel)
    kernels += split_kernels
    kernels += flex_kernels
    kernels += tomo_kernels
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
