function mask = tom_xmipp_mask(msize, type, origin, varargin)
%TOM_XMIPP_MASK generate a mask of size MSIZE: 'circular' R, 'crown' R1 R2,
%'rectangular' X Y [Z], 'gaussian' SIGMA, 'raised_cosine' R1 R2,
%'cylinder' R H. Negative radii select the complementary (inner) mask,
%as in the reference wrapper. Replaces tom_xmipp_mask.cpp.
%
%   mask = tom_xmipp_mask(msize, type, origin, p1, p2, ...)
if nargin < 3, origin = []; end
params = cell2mat(varargin);
inner = ~isempty(params) && all(params < 0);
out = xmipp_matlab_bridge('mask', struct('msize', msize, 'type', type, ...
    'origin', origin, 'params', params, 'inner', inner));
mask = out.mask;
end
