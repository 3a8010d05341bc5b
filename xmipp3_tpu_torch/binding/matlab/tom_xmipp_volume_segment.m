function [seg_mask, vol_seg] = tom_xmipp_volume_segment(vol, sampling, ...
    mass, type, enable_threshold, threshold, wang_radius, probabilistic)
%TOM_XMIPP_VOLUME_SEGMENT segment VOL to a binary mask holding MASS in
%'voxels', 'daltons' or 'amino acids' units (or an absolute THRESHOLD when
%ENABLE_THRESHOLD). Replaces tom_xmipp_volume_segment.cpp.
if nargin < 8, probabilistic = false; end
if nargin < 7, wang_radius = 3; end
if nargin < 6, threshold = 0; end
if nargin < 5, enable_threshold = false; end
out = xmipp_matlab_bridge('volume_segment', struct('vol', vol, ...
    'sampling', sampling, 'mass', mass, 'type', type, ...
    'enable_threshold', enable_threshold, 'threshold', threshold, ...
    'wang_radius', wang_radius, 'probabilistic', probabilistic));
seg_mask = out.seg_mask;
if nargout > 1
    vol_seg = out.vol_seg;
end
end
